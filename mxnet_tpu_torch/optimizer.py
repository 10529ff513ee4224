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
           "Test", "create", "get_updater", "Updater", "register"]

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


def _prep_grads(grads, rescale_grad, clip_gradient):
    """``ops/optim_ops.py::_prep_grad`` over a list of tensors."""
    g = torch._foreach_mul(grads, rescale_grad)
    if clip_gradient is not None and clip_gradient > 0:
        torch._foreach_clamp_min_(g, -clip_gradient)
        torch._foreach_clamp_max_(g, clip_gradient)
    return g


def _plus_wd(g, weights, wds):
    """``g + wd * weight`` over lists, in place into ``g``."""
    torch._foreach_add_(g, torch._foreach_mul(weights, wds))
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

    def fused_update(self, weights, grads, states, lrs, wds, counts):
        """Update every tensor of ``weights`` and of ``states`` (their raw
        state structures) in place, in one call: ``lrs``, ``wds`` and
        ``counts`` hold one value per tensor.  Raises
        ``NotImplementedError`` where there is no fused rule."""
        raise NotImplementedError("%s has no fused update"
                                  % type(self).__name__)


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
                  rescale_grad=self.rescale_grad, clip_gradient=self._clip())
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

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts):
        """The multi-precision slots go one by one through ``update_step``;
        the others through multi-tensor ops."""
        plain = [i for i, s in enumerate(states) if not isinstance(s, tuple)]
        for i in range(len(weights)):
            if isinstance(states[i], tuple):
                new_w, new_s = self.update_step(
                    weights[i], grads[i], states[i],
                    {"lr": lrs[i], "wd": wds[i], "t": counts[i]})
                weights[i].copy_(new_w)
                for dst, src in zip(states[i], new_s):
                    if dst is not None:
                        dst.copy_(src)
        if not plain:
            return
        ws = [weights[i] for i in plain]
        g = _prep_grads([grads[i] for i in plain], self.rescale_grad,
                        self._clip())
        step = _plus_wd(g, ws, [wds[i] for i in plain])
        torch._foreach_mul_(step, [lrs[i] for i in plain])
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

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts):
        g = _prep_grads(grads, self.rescale_grad, self._clip())
        if states[0] is None:
            step = _plus_wd(g, weights, wds)
        else:
            torch._foreach_mul_(states, self.momentum)
            torch._foreach_add_(states, g)
            step = torch._foreach_add(g, torch._foreach_mul(states,
                                                            self.momentum))
            _plus_wd(step, weights, wds)
        torch._foreach_mul_(step, lrs)
        torch._foreach_sub_(weights, step)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference ``:419``): a
    gradient step at lr/2 plus N(0, lr) noise, drawn from the weight's
    device generator (``random.generator``)."""

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

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts):
        g = _prep_grads(grads, self.rescale_grad, self._clip())
        step = _plus_wd(g, weights, wds)
        torch._foreach_mul_(step, [lr / 2 for lr in lrs])
        torch._foreach_sub_(weights, step)
        # one draw a tensor, in the order of the per-parameter loop
        noise = [self._noise(w) for w in weights]
        torch._foreach_mul_(noise, [math.sqrt(lr) for lr in lrs])
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

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts):
        g = _prep_grads(grads, self.rescale_grad, self._clip())
        prev = _part(states, 1)
        drift = torch._foreach_sub(weights, prev)
        gg = torch._foreach_mul(g, self.lamda)
        torch._foreach_mul_(gg, g)
        torch._foreach_mul_(gg, drift)
        comp = _plus_wd(g, weights, wds)
        torch._foreach_add_(comp, gg)
        torch._foreach_mul_(comp, lrs)
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

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts):
        means, vars_ = _part(states, 0), _part(states, 1)
        g = _plus_wd(_prep_grads(grads, self.rescale_grad, self._clip()),
                     weights, wds)
        torch._foreach_mul_(means, self.beta1)
        torch._foreach_add_(means, torch._foreach_mul(g, 1 - self.beta1))
        gg = torch._foreach_mul(g, g)
        torch._foreach_mul_(gg, 1 - self.beta2)
        torch._foreach_mul_(vars_, self.beta2)
        torch._foreach_add_(vars_, gg)
        step = torch._foreach_mul(means, [self._corrected_lr(lr, t)
                                          for lr, t in zip(lrs, counts)])
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

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts):
        g = _prep_grads(grads, self.rescale_grad, self._clip())
        torch._foreach_add_(states, torch._foreach_mul(g, g))
        den = torch._foreach_add(states, self.float_stable_eps)
        torch._foreach_sqrt_(den)
        step = torch._foreach_div(g, den)
        _plus_wd(step, weights, wds)
        torch._foreach_mul_(step, lrs)
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

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts):
        g = _plus_wd(_prep_grads(grads, self.rescale_grad, self._clip()),
                     weights, wds)
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
        step = torch._foreach_mul(g, lrs)
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

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts):
        g = _prep_grads(grads, self.rescale_grad, self._clip())
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
        decay = torch._foreach_mul(weights, wds)
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

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts):
        g = _prep_grads(grads, self.rescale_grad, self._clip())
        zs, ns = _part(states, 0), _part(states, 1)
        old_root = torch._foreach_sqrt(ns)
        torch._foreach_add_(ns, torch._foreach_mul(g, g))
        root = torch._foreach_sqrt(ns)
        inv_lrs = [1.0 / lr for lr in lrs]
        sigma = torch._foreach_sub(root, old_root)
        torch._foreach_mul_(sigma, inv_lrs)
        torch._foreach_add_(zs, g)
        torch._foreach_sub_(zs, torch._foreach_mul(sigma, weights))
        den = torch._foreach_add(root, self.beta)
        torch._foreach_mul_(den, inv_lrs)
        torch._foreach_add_(den, wds)
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

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts):
        g = _plus_wd(_prep_grads(grads, self.rescale_grad, self._clip()),
                     weights, wds)
        ms, us = _part(states, 0), _part(states, 1)
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, torch._foreach_mul(g, 1.0 - self.beta1))
        torch._foreach_mul_(us, self.beta2)
        torch._foreach_maximum_(us, torch._foreach_abs(g))
        step = torch._foreach_mul(ms, [self._corrected_lr(lr, t)
                                       for lr, t in zip(lrs, counts)])
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

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts):
        sch = [self._schedule(t) for t in counts]
        g = _plus_wd(_prep_grads(grads, self.rescale_grad, self._clip()),
                     weights, wds)
        ms, vs, scheds = _part(states, 0), _part(states, 1), _part(states, 2)
        torch._foreach_mul_(scheds, [s[0] for s in sch])
        sched_next = torch._foreach_mul(scheds, [s[1] for s in sch])
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
        v_hat = torch._foreach_mul(vs, [s[2] for s in sch])
        torch._foreach_mul_(g_hat, [1.0 - s[0] for s in sch])
        torch._foreach_mul_(m_hat, [s[1] for s in sch])
        torch._foreach_add_(g_hat, m_hat)
        torch._foreach_mul_(g_hat, lrs)
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

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts):
        g = _prep_grads(grads, self.rescale_grad, self._clip())
        if states[0] is None:
            sign = torch._foreach_sign(g)
        else:
            torch._foreach_mul_(states, self.momentum)
            torch._foreach_sub_(states, torch._foreach_mul(
                g, 1 - self.momentum))
            sign = torch._foreach_sign(torch._foreach_neg(states))
        _plus_wd(sign, weights, wds)
        torch._foreach_mul_(sign, lrs)
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
