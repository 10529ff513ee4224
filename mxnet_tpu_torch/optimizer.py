"""Optimizers: ``Optimizer``, ``SGD`` and ``Updater``.

Counterpart of ``mxnet_tpu/optimizer.py:99-397, 685-726``.  The
hyper-parameter rules are MXNet's: ``rescale_grad`` scales the gradient
first, ``clip_gradient`` (off when None or <= 0) clips it, and ``wd``
applies to the rescaled, clipped gradient, except on parameters whose
name (from ``param_idx2name``) ends neither in ``_weight`` nor in
``_gamma``: biases take no weight decay.  ``SGD`` updates each parameter
with one ``sgd_update`` or ``sgd_mom_update`` op, which writes the
weight and the momentum back into their NDArrays in place: no update
reads anything back to the host.
"""
from __future__ import annotations

from . import ndarray as nd

__all__ = ["Optimizer", "SGD", "Updater"]


class Optimizer:
    """Hyper-parameter bookkeeping shared by the optimizers."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.wd_mult = {name: 0.0 for name in self.idx2name.values()
                        if not name.endswith(("_weight", "_gamma"))}

    def _get_wd(self, index):
        return self.wd * self.wd_mult.get(self.idx2name.get(index), 1.0)

    def _clip(self):
        """clip_gradient in the kernel convention (-1 = off)."""
        return self.clip_gradient if self.clip_gradient else -1.0

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()


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
        kw = dict(lr=self.lr, wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad, clip_gradient=self._clip())
        if state is not None:
            nd.sgd_mom_update(weight, grad, state, out=weight,
                              momentum=self.momentum, **kw)
        else:
            nd.sgd_update(weight, grad, out=weight, **kw)


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
