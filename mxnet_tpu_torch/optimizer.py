"""Optimizers: ``Optimizer``, the reference's twelve update rules,
``Updater`` and ``create``.

Counterpart of ``mxnet_tpu/optimizer.py:99-726``.  The hyper-parameter
rules are MXNet's: ``rescale_grad`` scales the gradient first,
``clip_gradient`` (off when None or <= 0) clips it, and ``wd`` applies to
the rescaled, clipped gradient.  Per parameter, the learning rate and the
weight decay are multiplied by ``lr_mult`` and ``wd_mult``, looked up in
``param_dict`` (Gluon's Parameters, by slot), then by index, then by name
(``param_idx2name``): a name that ends neither in ``_weight`` nor in
``_gamma`` takes no decay, unless the bound symbol's ``__wd_mult__`` attr
(which Gluon's ``Parameter.var`` always sets) or ``set_wd_mult`` says
otherwise.  Each update counts per index (``_update_count``,
``num_update``); an ``lr_scheduler`` gives the learning rate at
``num_update``.

Each optimizer's rule is ``update_step(weight, grad, state, hyper)`` on
tensors (``hyper``: ``lr``, ``wd`` and the update count ``t``), through
the update ops of ``ops/optim_ops.py`` where the JAX package calls them.
``update`` runs it for one parameter and writes the weight and the state
back into their NDArrays in place.  ``fused_update`` updates a whole list
of parameters with PyTorch's multi-tensor (``_foreach``) ops, the same
operations in the same order, so that each element rounds as it does
through ``update``: the update of ``module.CachedTrainStep`` and of
Gluon's fused trainer step.  Where the JAX package computes a scalar in
fp32 on the device (Adam's, Adamax's and Nadam's bias corrections), it
is computed here in numpy fp32 on the host, the same IEEE operations.
Where it divides by a scalar (Ftrl's lr, Nadam's 1 - beta2^t), the port
multiplies by the reciprocal: on CUDA PyTorch divides a tensor by a host
scalar through its reciprocal but a multi-tensor division divides, and
a product rounds alike in both (at most one ulp from the JAX package's
quotient).  No update reads anything back from the device.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from .base import MXNetError
from . import ndarray as nd
from .ops import optim_ops as _kern

__all__ = ["Optimizer", "SGD", "NAG", "SGLD", "DCASGD", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "Ftrl", "Adamax", "Nadam", "Signum",
           "Test", "create", "get_updater", "Updater", "register",
           "TracedHyper"]

_REGISTRY = {}


def register(klass, name=None):
    _REGISTRY[(name or klass.__name__).lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by registered name (``"sgd"``), or the instance given."""
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise MXNetError("Cannot find optimizer '%s'. Registered: %s"
                         % (name, sorted(_REGISTRY)))
    return _REGISTRY[key](**kwargs)


# -- state structures: NDArrays (or tuples of them, None for none) ---------
def _state_raw(state):
    """The tensors of a state structure, in the same structure."""
    if state is None:
        return None
    if isinstance(state, nd.NDArray):
        return state._data
    return tuple(_state_raw(s) for s in state)


def _state_tensors(states):
    """The tensors of a list of raw state structures, in order."""
    out = []
    for s in states:
        if isinstance(s, tuple):
            out.extend(_state_tensors(s))
        elif s is not None:
            out.append(s)
    return out


def _state_writeback(state, new_raw):
    """Copy new tensor values into a state structure's NDArrays, in
    place (a tensor that already is the state's is left as it is)."""
    if state is None:
        return
    if isinstance(state, nd.NDArray):
        if new_raw is not state._data:
            state._set_data(new_raw)
        return
    for slot, val in zip(state, new_raw):
        _state_writeback(slot, val)


def _zeros_like(weight, dtype=None):
    return nd.zeros(weight.shape, ctx=weight.context,
                    dtype=dtype or weight._data.dtype)


class _Traced:
    """One traced hyper-parameter (``TracedHyper``): 0-dim device views of
    one value of the step's table, in fp64 and in fp32 (the fp32 rounding
    of the same double).  The slots that share a value share the object."""
    __slots__ = ("f64", "f32")

    def __init__(self, f64, f32):
        self.f64, self.f32 = f64, f32

    def at(self, dtype):
        """The view an operand of ``dtype`` is multiplied with: fp64 for an
        fp64 operand, fp32 (the op-math type) for the others."""
        return self.f64 if dtype == torch.float64 else self.f32


def _at(h, dtype):
    """A per-slot hyper-parameter as an operand of ``dtype`` takes it: a
    Python float as it is, a traced one as its view."""
    return h.at(dtype) if isinstance(h, _Traced) else h


def _traced(hs):
    return bool(hs) and isinstance(hs[0], _Traced)


def _apply(op, xs, hs, inplace=False):
    """``op(x, h)`` over lists (``op`` is ``"mul"`` or ``"add"``): new
    tensors, or with ``inplace`` into ``xs``.  ``hs`` holds Python floats
    (one multi-tensor op), or traced hyper-parameters (:class:`_Traced`).
    Each result rounds once, as a multi-tensor op with a float scalar
    rounds it: in the operand's op-math type (fp64 for fp64, fp32 for the
    others, which a 16-bit 0-dim tensor would not give), then to the
    operand's dtype."""
    foreach = getattr(torch, "_foreach_%s%s" % (op, "_" if inplace else ""))
    if not _traced(hs):
        return foreach(xs, hs)
    groups = {}
    for i, (x, h) in enumerate(zip(xs, hs)):
        groups.setdefault((id(h), x.dtype), ([], h.at(x.dtype)))[0].append(i)
    out = list(xs)
    for idx, h in groups.values():
        part = [xs[i] for i in idx]
        # the multi-tensor add's Tensor overload reads the scalar back to
        # the host, which a capture refuses; its product does not
        if op == "mul" and part[0].dtype == h.dtype:
            res = foreach(part, h)
        else:
            # h broadcast as a tensor promotes the result to its type (a
            # 16-bit operand's to fp32), and ``out`` rounds it once to the
            # operand's; the group goes through one flat buffer, so that is
            # one kernel and not one a slot
            flat = torch.cat([x.reshape(-1) for x in part])
            getattr(torch, op)(flat, h.expand(flat.shape), out=flat)
            res = [r.view(x.shape) for r, x in zip(
                torch.split(flat, [x.numel() for x in part]), part)]
            if inplace:
                torch._foreach_copy_(part, res)
        if not inplace:
            for i, r in zip(idx, res):
                out[i] = r
    return None if inplace else out


def _scale(xs, hs):
    """``[x * h]`` over lists, as new tensors (:func:`_apply`)."""
    return _apply("mul", xs, hs)


def _scale_(xs, hs):
    """``x *= h`` over lists (:func:`_apply`)."""
    _apply("mul", xs, hs, inplace=True)


def _shift_(xs, hs):
    """``x += h`` over lists (:func:`_apply`)."""
    _apply("add", xs, hs, inplace=True)


def _lr_wd(self, lrs, wds, counts):
    """``Optimizer.step_scalars`` of a rule that reads lr and wd as they
    are."""
    return {"lr": list(lrs), "wd": list(wds)}


def _prep_grads(grads, rescale_grad, clip_gradient):
    """``ops/optim_ops.py::_prep_grad`` over a list of tensors;
    ``rescale_grad`` a float, or traced (one tensor a slot)."""
    if isinstance(rescale_grad, (list, tuple)):
        g = _scale(grads, rescale_grad)
    else:
        g = torch._foreach_mul(grads, rescale_grad)
    if clip_gradient is not None and clip_gradient > 0:
        torch._foreach_clamp_min_(g, -clip_gradient)
        torch._foreach_clamp_max_(g, clip_gradient)
    return g


def _plus_wd(g, weights, wds):
    """``g + wd * weight`` over lists, in place into ``g``."""
    torch._foreach_add_(g, _scale(weights, wds))
    return g


def _part(states, i):
    """The ``i``-th tensor of each tuple state."""
    return [s[i] for s in states]


class Optimizer:
    """Hyper-parameter bookkeeping shared by the optimizers."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) if sym \
            else None
        self.param_dict = param_dict or {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    # -- hyper-parameters --------------------------------------------------
    @property
    def learning_rate(self):
        """The learning rate of the next update: the scheduler's at
        ``num_update``, else ``lr``."""
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined.")
        self.lr = lr

    def _mult_from_attrs(self, key):
        """The ``__lr_mult__``/``__wd_mult__`` attrs of the bound symbol's
        arguments."""
        found = {}
        if self.sym_info:
            attrs, arg_names = self.sym_info
            for name in arg_names:
                if name in attrs and key in attrs[name]:
                    found[name] = float(attrs[name][key])
        return found

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._mult_from_attrs("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {name: 0.0 for name in self.idx2name.values()
                        if not name.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(self._mult_from_attrs("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.setdefault(index,
                                                    self.begin_num_update)
        self._index_update_count[index] = count + 1
        self.num_update = max(count + 1, self.num_update)

    def _resolve_mult(self, index, table):
        if index in self.param_dict:
            p = self.param_dict[index]
            return p.lr_mult if table is self.lr_mult else p.wd_mult
        if index in table:
            return table[index]
        name = self.idx2name.get(index)
        return table.get(name, 1.0) if name is not None else 1.0

    def _get_lr(self, index):
        base = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return base * self._resolve_mult(index, self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._resolve_mult(index, self.wd_mult)

    def _clip(self):
        """clip_gradient in the kernel convention (-1 = off)."""
        return self.clip_gradient if self.clip_gradient else -1.0

    # -- the update entry points -------------------------------------------
    def create_state(self, index, weight):
        return None

    def update_step(self, weight, grad, state, hyper):
        """The rule on tensors: ``hyper`` holds ``lr``, ``wd`` and ``t``;
        returns (new weight, new state)."""
        raise NotImplementedError("%s has no update_step"
                                  % type(self).__name__)

    def supports_fused(self):
        """True where ``fused_update`` may replace the per-parameter
        ``update`` loop bit for bit: the rule is ``update_step`` and the
        optimizer keeps the shared ``update`` (reference ``:224``)."""
        cls = type(self)
        return (cls.update is Optimizer.update
                and cls.update_step is not Optimizer.update_step)

    def update(self, index, weight, grad, state):
        """Update one parameter: count the update, resolve its lr and wd,
        run ``update_step`` and write the weight and state back in place."""
        self._update_count(index)
        hyper = {"lr": self._get_lr(index), "wd": self._get_wd(index),
                 "t": self._index_update_count[index]}
        with torch.no_grad():
            new_w, new_state = self.update_step(weight._data, grad._data,
                                                _state_raw(state), hyper)
        # the state first: it may hold the weight's old value (DCASGD)
        _state_writeback(state, new_state)
        weight._set_data(new_w)

    def fused_update(self, weights, grads, states, lrs, wds, counts,
                     traced=None):
        """Update every tensor of ``weights`` and of ``states`` (their raw
        state structures) in place, in one call: ``lrs``, ``wds`` and
        ``counts`` hold one value per tensor.  With ``traced`` (a captured
        update, ``TracedHyper.unpack``) the rule reads its
        ``step_scalars`` and ``rescale_grad`` from there, device views one
        a slot, and not ``lrs``, ``wds`` or ``counts``.  Raises
        ``NotImplementedError`` where there is no fused rule."""
        raise NotImplementedError("%s has no fused update"
                                  % type(self).__name__)

    # -- captured fused updates (``capture``) -------------------------------
    # The optimizer's own attributes that a step, and so a captured graph,
    # does not freeze: the per-slot lr and wd come from these, and
    # ``rescale_grad`` is traced or keyed on its own.
    _PER_STEP = ("lr", "wd", "rescale_grad", "num_update",
                 "begin_num_update")
    # whether the update draws from the device's generator
    draws_random = False

    def static_hyper(self):
        """The class and every scalar attribute a fused update reads as a
        constant (momentum, betas, epsilon, clip_gradient, ...): a captured
        update is keyed on them."""
        return (type(self),) + tuple(sorted(
            (k, v) for k, v in vars(self).items() if k not in self._PER_STEP
            and (v is None or isinstance(v, (bool, int, float)))))

    def step_scalars(self, lrs, wds, counts):
        """The per-slot scalars that ``fused_update`` reads each step, by
        name, as the host computes them: lr and wd, and what the rule
        derives from them and the update counts (Adam's bias-corrected lr,
        Nadam's momentum schedule, ...).  A captured update reads them
        from a device tensor the host fills before each replay
        (``TracedHyper``), and ``fused_update(..., traced=)`` takes them
        so.  None where the rule's ``fused_update`` takes only host
        floats, which a capture then freezes and keys on."""
        return None

    def _hyper(self, lrs, wds, counts, traced):
        """A ``fused_update``'s per-slot scalars (``step_scalars``, traced
        or as host floats) and its ``rescale_grad`` (traced: one value a
        slot; else the float)."""
        if traced is not None:
            return traced, traced["rescale_grad"]
        return self.step_scalars(lrs, wds, counts), self.rescale_grad


@register
class SGD(Optimizer):
    """SGD with momentum: ``mom = momentum * mom - lr * (g + wd * w)``,
    ``w += mom``, with ``g = clip(rescale_grad * grad)``; with
    ``multi_precision`` an fp16 weight is updated through an fp32 copy
    (reference ``:434``)."""

    def __init__(self, momentum=0.0, lazy_update=True,
                 multi_precision=False, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.multi_precision = multi_precision

    def create_state(self, index, weight):
        if self.multi_precision and weight._data.dtype == torch.float16:
            mom = _zeros_like(weight, torch.float32) if self.momentum \
                else None
            return (mom, weight.astype(np.float32))
        if self.momentum != 0.0:
            return _zeros_like(weight)
        return None

    def update_step(self, w, g, state, hyper):
        kw = dict(lr=hyper["lr"], wd=hyper["wd"],
                  rescale_grad=hyper.get("rescale_grad", self.rescale_grad),
                  clip_gradient=self._clip())
        if isinstance(state, tuple):  # multi-precision
            mom, w32 = state
            if mom is not None:
                new_w, new_mom, new_w32 = _kern._mp_sgd_mom_update(
                    w, g, mom, w32, momentum=self.momentum, **kw)
                return new_w, (new_mom, new_w32)
            new_w, new_w32 = _kern._mp_sgd_update(w, g, w32, **kw)
            return new_w, (None, new_w32)
        if state is not None:
            return _kern._sgd_mom_update(w, g, state, momentum=self.momentum,
                                         **kw)
        return _kern._sgd_update(w, g, **kw), None

    step_scalars = _lr_wd

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts,
                     traced=None):
        """The multi-precision slots go one by one through ``update_step``;
        the others through multi-tensor ops."""
        h, rescale = self._hyper(lrs, wds, counts, traced)
        lrs, wds = h["lr"], h["wd"]
        plain = [i for i, s in enumerate(states) if not isinstance(s, tuple)]
        for i in range(len(weights)):
            if isinstance(states[i], tuple):
                # the fp32 copy is updated: fp32 operands
                f32 = torch.float32
                new_w, new_s = self.update_step(
                    weights[i], grads[i], states[i],
                    {"lr": _at(lrs[i], f32), "wd": _at(wds[i], f32),
                     "rescale_grad": _at(rescale[i], f32) if traced
                     else rescale})
                weights[i].copy_(new_w)
                for dst, src in zip(states[i], new_s):
                    if dst is not None:
                        dst.copy_(src)
        if not plain:
            return
        ws = [weights[i] for i in plain]
        g = _prep_grads([grads[i] for i in plain],
                        [rescale[i] for i in plain] if traced else rescale,
                        self._clip())
        step = _plus_wd(g, ws, [wds[i] for i in plain])
        _scale_(step, [lrs[i] for i in plain])
        if self.momentum == 0.0:
            torch._foreach_sub_(ws, step)
            return
        moms = [states[i] for i in plain]
        torch._foreach_mul_(moms, self.momentum)
        torch._foreach_sub_(moms, step)
        torch._foreach_add_(ws, moms)


register(SGD, "ccsgd")


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference ``:398``)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def update_step(self, w, g, state, hyper):
        lr, wd = hyper["lr"], hyper["wd"]
        g = _kern._prep_grad(g, self.rescale_grad, self._clip())
        if state is None:
            return w - lr * (g + wd * w), None
        new_mom = self.momentum * state + g
        lookahead = g + self.momentum * new_mom
        return w - lr * (lookahead + wd * w), new_mom

    step_scalars = _lr_wd

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts,
                     traced=None):
        h, rescale = self._hyper(lrs, wds, counts, traced)
        g = _prep_grads(grads, rescale, self._clip())
        if states[0] is None:
            step = _plus_wd(g, weights, h["wd"])
        else:
            torch._foreach_mul_(states, self.momentum)
            torch._foreach_add_(states, g)
            step = torch._foreach_add(g, torch._foreach_mul(states,
                                                            self.momentum))
            _plus_wd(step, weights, h["wd"])
        _scale_(step, h["lr"])
        torch._foreach_sub_(weights, step)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference ``:419``): a
    gradient step at lr/2 plus N(0, lr) noise, drawn from the weight's
    device generator (``random.generator``)."""

    draws_random = True

    def _noise(self, w):
        from . import random as _random
        gen = _random.generator(w.device)
        return torch.randn(w.shape, generator=gen, dtype=w.dtype,
                           device=w.device)

    def update_step(self, w, g, state, hyper):
        lr, wd = hyper["lr"], hyper["wd"]
        g = _kern._prep_grad(g, self.rescale_grad, self._clip())
        stepped = w - lr / 2 * (g + wd * w)
        return stepped + math.sqrt(lr) * self._noise(w), None

    def step_scalars(self, lrs, wds, counts):
        return {"wd": list(wds), "half_lr": [lr / 2 for lr in lrs],
                "sqrt_lr": [math.sqrt(lr) for lr in lrs]}

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts,
                     traced=None):
        h, rescale = self._hyper(lrs, wds, counts, traced)
        g = _prep_grads(grads, rescale, self._clip())
        step = _plus_wd(g, weights, h["wd"])
        _scale_(step, h["half_lr"])
        torch._foreach_sub_(weights, step)
        # one draw a tensor, in the order of the per-parameter loop
        noise = [self._noise(w) for w in weights]
        _scale_(noise, h["sqrt_lr"])
        torch._foreach_add_(weights, noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (reference ``:440``); the state holds
    the momentum and the weight of the previous update."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = _zeros_like(weight) if self.momentum != 0.0 else None
        return (mom, weight.copy())

    def update_step(self, w, g, state, hyper):
        lr, wd = hyper["lr"], hyper["wd"]
        g = _kern._prep_grad(g, self.rescale_grad, self._clip())
        mom, prev_w = state
        compensated = g + wd * w + self.lamda * g * g * (w - prev_w)
        if mom is not None:
            new_mom = self.momentum * mom - lr * compensated
            return w + new_mom, (new_mom, w)
        return w - lr * compensated, (None, w)

    step_scalars = _lr_wd

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts,
                     traced=None):
        h, rescale = self._hyper(lrs, wds, counts, traced)
        g = _prep_grads(grads, rescale, self._clip())
        prev = _part(states, 1)
        drift = torch._foreach_sub(weights, prev)
        gg = torch._foreach_mul(g, self.lamda)
        torch._foreach_mul_(gg, g)
        torch._foreach_mul_(gg, drift)
        comp = _plus_wd(g, weights, h["wd"])
        torch._foreach_add_(comp, gg)
        _scale_(comp, h["lr"])
        torch._foreach_copy_(prev, weights)
        if states[0][0] is None:
            torch._foreach_sub_(weights, comp)
            return
        moms = _part(states, 0)
        torch._foreach_mul_(moms, self.momentum)
        torch._foreach_sub_(moms, comp)
        torch._foreach_add_(weights, moms)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into lr (reference ``:465``),
    computed in fp32 as the JAX package computes it."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _corrected_lr(self, lr, t):
        f32 = np.float32
        t = f32(t)
        return float(f32(lr) * np.sqrt(f32(1.0) - f32(self.beta2) ** t)
                     / (f32(1.0) - f32(self.beta1) ** t))

    def update_step(self, w, g, state, hyper):
        mean, var = state
        new_w, new_mean, new_var = _kern._adam_update(
            w, g, mean, var, lr=self._corrected_lr(hyper["lr"], hyper["t"]),
            wd=hyper["wd"], beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, rescale_grad=self.rescale_grad,
            clip_gradient=self._clip())
        return new_w, (new_mean, new_var)

    def step_scalars(self, lrs, wds, counts):
        return {"lr": [self._corrected_lr(lr, t)
                       for lr, t in zip(lrs, counts)], "wd": list(wds)}

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts,
                     traced=None):
        h, rescale = self._hyper(lrs, wds, counts, traced)
        means, vars_ = _part(states, 0), _part(states, 1)
        g = _plus_wd(_prep_grads(grads, rescale, self._clip()), weights,
                     h["wd"])
        torch._foreach_mul_(means, self.beta1)
        torch._foreach_add_(means, torch._foreach_mul(g, 1 - self.beta1))
        gg = torch._foreach_mul(g, g)
        torch._foreach_mul_(gg, 1 - self.beta2)
        torch._foreach_mul_(vars_, self.beta2)
        torch._foreach_add_(vars_, gg)
        step = _scale(means, h["lr"])
        den = torch._foreach_sqrt(vars_)
        torch._foreach_add_(den, self.epsilon)
        torch._foreach_div_(step, den)
        torch._foreach_sub_(weights, step)


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference ``:495``); the state is the squared-gradient
    history."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update_step(self, w, g, state, hyper):
        lr, wd = hyper["lr"], hyper["wd"]
        g = _kern._prep_grad(g, self.rescale_grad, self._clip())
        hist = state + g * g
        stepped = w - lr * (g / torch.sqrt(hist + self.float_stable_eps)
                            + wd * w)
        return stepped, hist

    step_scalars = _lr_wd

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts,
                     traced=None):
        h, rescale = self._hyper(lrs, wds, counts, traced)
        g = _prep_grads(grads, rescale, self._clip())
        torch._foreach_add_(states, torch._foreach_mul(g, g))
        den = torch._foreach_add(states, self.float_stable_eps)
        torch._foreach_sqrt_(den)
        step = torch._foreach_div(g, den)
        _plus_wd(step, weights, h["wd"])
        _scale_(step, h["lr"])
        torch._foreach_sub_(weights, step)


@register
class RMSProp(Optimizer):
    """RMSProp, plain or centered (reference ``:515``)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered, self.epsilon = centered, epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        n = 3 if self.centered else 1
        return tuple(_zeros_like(weight) for _ in range(n))

    def update_step(self, w, g, state, hyper):
        kw = dict(lr=hyper["lr"], wd=hyper["wd"], gamma1=self.gamma1,
                  epsilon=self.epsilon, rescale_grad=self.rescale_grad,
                  clip_gradient=self._clip(),
                  clip_weights=self.clip_weights or -1.0)
        if self.centered:
            n, avg, delta = state
            new_w, nn, ng, nd_ = _kern._rmspropalex_update(
                w, g, n, avg, delta, gamma2=self.gamma2, **kw)
            return new_w, (nn, ng, nd_)
        (n,) = state
        new_w, nn = _kern._rmsprop_update(w, g, n, **kw)
        return new_w, (nn,)

    step_scalars = _lr_wd

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts,
                     traced=None):
        h, rescale = self._hyper(lrs, wds, counts, traced)
        g = _plus_wd(_prep_grads(grads, rescale, self._clip()), weights,
                     h["wd"])
        ns = _part(states, 0)
        gg = torch._foreach_mul(g, g)
        torch._foreach_mul_(gg, 1 - self.gamma1)
        torch._foreach_mul_(ns, self.gamma1)
        torch._foreach_add_(ns, gg)
        if self.centered:
            avgs, deltas = _part(states, 1), _part(states, 2)
            torch._foreach_mul_(avgs, self.gamma1)
            torch._foreach_add_(avgs, torch._foreach_mul(g, 1 - self.gamma1))
            den = torch._foreach_sub(ns, torch._foreach_mul(avgs, avgs))
            torch._foreach_add_(den, self.epsilon)
        else:
            den = torch._foreach_add(ns, self.epsilon)
        torch._foreach_sqrt_(den)
        step = _scale(g, h["lr"])
        torch._foreach_div_(step, den)
        if self.centered:
            torch._foreach_mul_(deltas, self.gamma2)
            torch._foreach_sub_(deltas, step)
            torch._foreach_add_(weights, deltas)
        else:
            torch._foreach_sub_(weights, step)
        if self.clip_weights is not None and self.clip_weights > 0:
            torch._foreach_clamp_min_(weights, -self.clip_weights)
            torch._foreach_clamp_max_(weights, self.clip_weights)


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference ``:545``); the state is (E[g^2], E[dx^2])."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update_step(self, w, g, state, hyper):
        wd = hyper["wd"]
        g = _kern._prep_grad(g, self.rescale_grad, self._clip())
        acc_g, acc_dx = state
        acc_g = self.rho * acc_g + (1.0 - self.rho) * g * g
        dx = torch.sqrt((acc_dx + self.epsilon) / (acc_g + self.epsilon)) * g
        acc_dx = self.rho * acc_dx + (1.0 - self.rho) * dx * dx
        return w - dx - wd * w, (acc_g, acc_dx)

    def step_scalars(self, lrs, wds, counts):
        return {"wd": list(wds)}

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts,
                     traced=None):
        h, rescale = self._hyper(lrs, wds, counts, traced)
        g = _prep_grads(grads, rescale, self._clip())
        acc_g, acc_dx = _part(states, 0), _part(states, 1)
        gg = torch._foreach_mul(g, 1.0 - self.rho)
        torch._foreach_mul_(gg, g)
        torch._foreach_mul_(acc_g, self.rho)
        torch._foreach_add_(acc_g, gg)
        dx = torch._foreach_add(acc_dx, self.epsilon)
        torch._foreach_div_(dx, torch._foreach_add(acc_g, self.epsilon))
        torch._foreach_sqrt_(dx)
        torch._foreach_mul_(dx, g)
        dd = torch._foreach_mul(dx, 1.0 - self.rho)
        torch._foreach_mul_(dd, dx)
        torch._foreach_mul_(acc_dx, self.rho)
        torch._foreach_add_(acc_dx, dd)
        decay = _scale(weights, h["wd"])
        torch._foreach_sub_(weights, dx)
        torch._foreach_sub_(weights, decay)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (reference ``:566``); the state is (z, n)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update_step(self, w, g, state, hyper):
        z, n = state
        new_w, new_z, new_n = _kern._ftrl_update(
            w, g, z, n, lr=hyper["lr"], wd=hyper["wd"], lamda1=self.lamda1,
            beta=self.beta, rescale_grad=self.rescale_grad,
            clip_gradient=self._clip())
        return new_w, (new_z, new_n)

    def step_scalars(self, lrs, wds, counts):
        return {"inv_lr": [1.0 / lr for lr in lrs], "wd": list(wds)}

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts,
                     traced=None):
        h, rescale = self._hyper(lrs, wds, counts, traced)
        g = _prep_grads(grads, rescale, self._clip())
        zs, ns = _part(states, 0), _part(states, 1)
        old_root = torch._foreach_sqrt(ns)
        torch._foreach_add_(ns, torch._foreach_mul(g, g))
        root = torch._foreach_sqrt(ns)
        sigma = torch._foreach_sub(root, old_root)
        _scale_(sigma, h["inv_lr"])
        torch._foreach_add_(zs, g)
        torch._foreach_sub_(zs, torch._foreach_mul(sigma, weights))
        den = torch._foreach_add(root, self.beta)
        _scale_(den, h["inv_lr"])
        _shift_(den, h["wd"])
        num = torch._foreach_sign(zs)
        torch._foreach_mul_(num, self.lamda1)
        num = torch._foreach_sub(zs, num)
        torch._foreach_neg_(num)
        torch._foreach_div_(num, den)
        for w, z, v in zip(weights, zs, num):
            w.copy_(torch.where(torch.abs(z) <= self.lamda1,
                                torch.zeros_like(w), v))


@register
class Adamax(Optimizer):
    """AdaMax, the infinity-norm variant of Adam (reference ``:586``); the
    bias correction in fp32 as the JAX package computes it."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def _corrected_lr(self, lr, t):
        f32 = np.float32
        return float(f32(lr) / (f32(1.0) - f32(self.beta1) ** f32(t)))

    def update_step(self, w, g, state, hyper):
        lr = self._corrected_lr(hyper["lr"], hyper["t"])
        g = _kern._prep_grad(g, self.rescale_grad, self._clip()) \
            + hyper["wd"] * w
        m, u = state
        m = self.beta1 * m + (1.0 - self.beta1) * g
        u = torch.maximum(self.beta2 * u, torch.abs(g))
        return w - lr * m / u, (m, u)

    def step_scalars(self, lrs, wds, counts):
        return {"lr": [self._corrected_lr(lr, t)
                       for lr, t in zip(lrs, counts)], "wd": list(wds)}

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts,
                     traced=None):
        h, rescale = self._hyper(lrs, wds, counts, traced)
        g = _plus_wd(_prep_grads(grads, rescale, self._clip()), weights,
                     h["wd"])
        ms, us = _part(states, 0), _part(states, 1)
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, torch._foreach_mul(g, 1.0 - self.beta1))
        torch._foreach_mul_(us, self.beta2)
        torch._foreach_maximum_(us, torch._foreach_abs(g))
        step = _scale(ms, h["lr"])
        torch._foreach_div_(step, us)
        torch._foreach_sub_(weights, step)


@register
class Nadam(Optimizer):
    """Nesterov Adam (reference ``:610``); the product of the momentum
    schedule rides in the state (fp32, one element), and the schedule's
    scalars are fp32 as the JAX package computes them."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                nd.ones((1,), ctx=weight.context))  # running mu product

    def _schedule(self, t):
        """(mu_t, mu_next, 1 / (1 - beta2^t)), the first two and 1 - beta2^t
        in fp32.  v is multiplied by the reciprocal where the JAX package
        divides, as ``ftrl_update`` multiplies by 1/lr: a product rounds
        alike in the per-parameter and the multi-tensor update on every
        device."""
        f32 = np.float32
        t = f32(t)
        sd, b1 = f32(self.schedule_decay), f32(self.beta1)
        mu_t = b1 * (f32(1.0) - f32(0.5) * f32(0.96) ** (t * sd))
        mu_next = b1 * (f32(1.0) - f32(0.5) * f32(0.96)
                        ** ((t + f32(1.0)) * sd))
        return (float(mu_t), float(mu_next),
                1.0 / float(f32(1.0) - f32(self.beta2) ** t))

    def update_step(self, w, g, state, hyper):
        lr, wd = hyper["lr"], hyper["wd"]
        mu_t, mu_next, inv_v_corr = self._schedule(hyper["t"])
        g = _kern._prep_grad(g, self.rescale_grad, self._clip()) + wd * w
        m, v, sched = state
        sched = sched * mu_t
        sched_next = sched * mu_next
        m = self.beta1 * m + (1.0 - self.beta1) * g
        v = self.beta2 * v + (1.0 - self.beta2) * g * g
        g_hat = g / (1.0 - sched)
        m_hat = m / (1.0 - sched_next)
        v_hat = v * inv_v_corr
        m_bar = (1.0 - mu_t) * g_hat + mu_next * m_hat
        return w - lr * m_bar / (torch.sqrt(v_hat) + self.epsilon), \
            (m, v, sched)

    def step_scalars(self, lrs, wds, counts):
        sch = [self._schedule(t) for t in counts]
        return {"lr": list(lrs), "wd": list(wds),
                "mu_t": [s[0] for s in sch], "mu_next": [s[1] for s in sch],
                "inv_v_corr": [s[2] for s in sch],
                "one_minus_mu_t": [1.0 - s[0] for s in sch]}

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts,
                     traced=None):
        h, rescale = self._hyper(lrs, wds, counts, traced)
        g = _plus_wd(_prep_grads(grads, rescale, self._clip()), weights,
                     h["wd"])
        ms, vs, scheds = _part(states, 0), _part(states, 1), _part(states, 2)
        _scale_(scheds, h["mu_t"])
        sched_next = _scale(scheds, h["mu_next"])
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, torch._foreach_mul(g, 1.0 - self.beta1))
        gg = torch._foreach_mul(g, 1.0 - self.beta2)
        torch._foreach_mul_(gg, g)
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_add_(vs, gg)
        one_minus = torch._foreach_neg(scheds)
        torch._foreach_add_(one_minus, 1.0)
        g_hat = torch._foreach_div(g, one_minus)
        torch._foreach_neg_(sched_next)
        torch._foreach_add_(sched_next, 1.0)
        m_hat = torch._foreach_div(ms, sched_next)
        v_hat = _scale(vs, h["inv_v_corr"])
        _scale_(g_hat, h["one_minus_mu_t"])
        _scale_(m_hat, h["mu_next"])
        torch._foreach_add_(g_hat, m_hat)
        _scale_(g_hat, h["lr"])
        den = torch._foreach_sqrt(v_hat)
        torch._foreach_add_(den, self.epsilon)
        torch._foreach_div_(g_hat, den)
        torch._foreach_sub_(weights, g_hat)


@register
class Signum(Optimizer):
    """Sign-of-gradient SGD with momentum (the ``signum_update`` and
    ``signsgd_update`` ops; reference ``:646``)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.wd_lh = momentum, wd_lh

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def update_step(self, w, g, state, hyper):
        kw = dict(lr=hyper["lr"], wd=hyper["wd"],
                  rescale_grad=self.rescale_grad, clip_gradient=self._clip())
        if state is not None:
            return _kern._signum_update(w, g, state, momentum=self.momentum,
                                        wd_lh=self.wd_lh, **kw)
        return _kern._signsgd_update(w, g, **kw), None

    step_scalars = _lr_wd

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts,
                     traced=None):
        h, rescale = self._hyper(lrs, wds, counts, traced)
        g = _prep_grads(grads, rescale, self._clip())
        if states[0] is None:
            sign = torch._foreach_sign(g)
        else:
            torch._foreach_mul_(states, self.momentum)
            torch._foreach_sub_(states, torch._foreach_mul(
                g, 1 - self.momentum))
            sign = torch._foreach_sign(torch._foreach_neg(states))
        _plus_wd(sign, weights, h["wd"])
        _scale_(sign, h["lr"])
        torch._foreach_sub_(weights, sign)


@register
class Test(Optimizer):
    """``w -= rescale_grad * g``; the state mirrors the weight (reference
    ``:667``).  It keeps its own ``update``, so it has no fused one."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update_step(self, w, g, state, hyper):
        new_w = w - self.rescale_grad * g
        return new_w, new_w

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            new_w, new_s = self.update_step(weight._data, grad._data,
                                            _state_raw(state), {})
        _state_writeback(state, new_s)
        weight._set_data(new_w)


class TracedHyper:
    """The hyper-parameters of one captured ``fused_update``, the JAX
    package's traced ``hyper`` dict (``module/cached_step.py:181-185``,
    ``gluon/fused_trainer.py``).  A graph freezes a Python float, so
    ``values`` holds fp64 host numbers, computed each step by the
    optimizer's own arithmetic (``step_scalars``): ``rescale_grad``, then
    each distinct value of each per-slot scalar (lr, wd, Adam's
    bias-corrected lr, Nadam's schedule, ...).  The step copies ``values``
    into a device tensor before each replay, and :meth:`unpack` (called
    while the graph is captured) gives each slot views of it: fp64 for an
    fp64 operand, the fp32 rounding of the same double for the others, so
    that the update rounds as it does with floats.  ``key`` is what the
    graph depends on: the optimizer's ``static_hyper`` and which slots
    share a value, so a learning-rate schedule or a changing update count
    replays the same graph.  A rule without ``step_scalars`` keys on its
    floats (``rescale_grad``, lr, wd and the counts): a change recaptures,
    it never replays stale, and its new program replaces the old one of
    its ``family`` (``capture.StepCache.program``)."""

    def __init__(self, opt, lrs, wds, counts):
        named = opt.step_scalars(lrs, wds, counts)
        if named is None:
            self._host = (list(lrs), list(wds), list(counts))
            self.family = ("host", opt.static_hyper())
            self.key = self.family + ((opt.rescale_grad,),) + tuple(
                tuple(v) for v in self._host)
            self.values = torch.zeros(0, dtype=torch.float64)
            return
        self._host, self.family = None, None
        table = {("rescale_grad", float(opt.rescale_grad)): 0}
        self._at = {name: tuple(table.setdefault((name, float(v)), len(table))
                                for v in vals)
                    for name, vals in named.items()}
        self._n = len(lrs)
        self.key = ("traced", opt.static_hyper(), tuple(self._at.items()))
        self.values = torch.tensor([v for _, v in table], dtype=torch.float64)

    def unpack(self, values):
        """``fused_update``'s keyword arguments from ``values`` on the
        device (its static copy)."""
        if self._host is not None:
            lrs, wds, counts = self._host
            return dict(lrs=lrs, wds=wds, counts=counts)
        f32, views = values.float(), {}

        def at(idx):
            return [views.setdefault(j, _Traced(values[j], f32[j]))
                    for j in idx]
        traced = {name: at(idx) for name, idx in self._at.items()}
        traced["rescale_grad"] = at([0] * self._n)
        return dict(lrs=None, wds=None, counts=None, traced=traced)


class Updater:
    """Per-index stateful wrapper (reference ``get_updater``): creates the
    optimizer state of an index at its first update; ``get_states`` and
    ``set_states`` carry the states (and the optimizer) as a pickle, in
    memory."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def set_states(self, states):
        payload = pickle.loads(states)
        if isinstance(payload, tuple) and len(payload) == 2:
            self.states, maybe_opt = payload
            if maybe_opt is not None:
                self.optimizer = maybe_opt
        else:
            self.states = payload

    def get_states(self, dump_optimizer=False):
        return pickle.dumps((self.states, self.optimizer) if dump_optimizer
                            else self.states)


def get_updater(optimizer):
    return Updater(optimizer)
