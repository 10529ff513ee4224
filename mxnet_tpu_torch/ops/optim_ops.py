"""Optimizer-update ops: ``sgd_update`` and ``sgd_mom_update``.

Counterpart of ``mxnet_tpu/ops/optim_ops.py:19-40``, with the reference
kernels' semantics: ``wd`` applies to the rescaled, clipped gradient.
``sgd_mom_update`` has two outputs, one visible; the second is the new
momentum, written back into the ``mom`` input (``aux_updates={2: 1}``).
"""
from __future__ import annotations

import torch

from .registry import register


def _prep_grad(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@register("sgd_update", nondiff_inputs=(0, 1))
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True, **kw):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


@register("sgd_mom_update", nondiff_inputs=(0, 1, 2), num_outputs=2,
          num_visible_outputs=1, aux_updates={2: 1})
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                    **kw):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight)
    return weight + new_mom, new_mom
