"""Optimizers: ``Optimizer``, ``SGD``, ``Updater`` and ``create``.

Counterpart of ``mxnet_tpu/optimizer.py:50, 99-201, 397-460, 685-726``.
The hyper-parameter rules are MXNet's: ``rescale_grad`` scales the
gradient first, ``clip_gradient`` (off when None or <= 0) clips it, and
``wd`` applies to the rescaled, clipped gradient.  Per parameter, the
learning rate and the weight decay are multiplied by ``lr_mult`` and
``wd_mult``, looked up by index, then by name (``param_idx2name``): a
name that ends neither in ``_weight`` nor in ``_gamma`` takes no decay,
unless the bound symbol's ``__wd_mult__`` attr (which Gluon's
``Parameter.var`` always sets) or ``set_wd_mult`` says otherwise.  Each
update counts per index (``_update_count``, ``num_update``).

``SGD.update`` updates one parameter with one ``sgd_update`` or
``sgd_mom_update`` op, which writes the weight and the momentum back
into their NDArrays in place.  ``SGD.fused_update`` updates a whole list
of parameters with PyTorch's multi-tensor (``_foreach``) ops, the same
arithmetic in the same order: the update of ``module.CachedTrainStep``.
No update reads anything back to the host.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from . import ndarray as nd

__all__ = ["Optimizer", "SGD", "Updater", "create", "register",
           "get_updater"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
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


class Optimizer:
    """Hyper-parameter bookkeeping shared by the optimizers."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, sym=None,
                 begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) if sym \
            else None
        self.set_lr_mult({})
        self.set_wd_mult({})

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
        if index in table:
            return table[index]
        name = self.idx2name.get(index)
        return table.get(name, 1.0) if name is not None else 1.0

    def _get_lr(self, index):
        return self.lr * self._resolve_mult(index, self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._resolve_mult(index, self.wd_mult)

    def _clip(self):
        """clip_gradient in the kernel convention (-1 = off)."""
        return self.clip_gradient if self.clip_gradient else -1.0

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def fused_update(self, weights, grads, states, lrs, wds):
        """Update every tensor of ``weights`` (and its state) in place in
        one call; raises ``NotImplementedError`` where the optimizer has
        none (then ``CachedTrainStep`` is not used)."""
        raise NotImplementedError("%s has no fused update"
                                  % type(self).__name__)


@register
class SGD(Optimizer):
    """SGD with momentum: ``mom = momentum * mom - lr * (g + wd * w)``,
    ``w += mom``, with ``g = clip(rescale_grad * grad)``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return nd.zeros(weight.shape, ctx=weight.context,
                        dtype=weight._data.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad, clip_gradient=self._clip())
        if state is not None:
            nd.sgd_mom_update(weight, grad, state, out=weight,
                              momentum=self.momentum, **kw)
        else:
            nd.sgd_update(weight, grad, out=weight, **kw)

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds):
        """``update`` over lists of tensors with multi-tensor ops: the ops
        of ``ops/optim_ops.py`` in their order, so each element rounds as
        it does there.  ``lrs``/``wds`` hold one float per tensor."""
        g = torch._foreach_mul(grads, self.rescale_grad)
        clip = self._clip()
        if clip > 0:
            torch._foreach_clamp_min_(g, -clip)
            torch._foreach_clamp_max_(g, clip)
        step = torch._foreach_add(g, torch._foreach_mul(weights, wds))
        torch._foreach_mul_(step, lrs)
        if self.momentum == 0.0:
            torch._foreach_sub_(weights, step)
            return
        torch._foreach_mul_(states, self.momentum)
        torch._foreach_sub_(states, step)
        torch._foreach_add_(weights, states)


class Updater:
    """Per-index stateful wrapper (reference ``get_updater``): creates the
    optimizer state of an index at its first update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
