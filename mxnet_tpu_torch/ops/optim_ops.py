"""Optimizer-update ops.

Counterpart of ``mxnet_tpu/ops/optim_ops.py:19-126``, with the reference
kernels' semantics and the JAX package's order of operations:
``_prep_grad`` first (``rescale_grad``, then ``clip_gradient``), and
``wd`` applied to the rescaled, clipped gradient.  Each op's extra
outputs are the new optimizer state, written back into the state inputs
(``aux_updates``) and never differentiated; the first output, the new
weight, is the only visible one.  ``mp_*`` ops keep an fp32 master copy
of a half-precision weight and update that.
"""
from __future__ import annotations

import torch

from .registry import register


def _prep_grad(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w


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


@register("mp_sgd_update", nondiff_inputs=(0, 1, 2), num_outputs=2,
          num_visible_outputs=1, aux_updates={2: 1})
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, **kw):
    g = _prep_grad(grad.to(torch.float32), rescale_grad, clip_gradient)
    new_w32 = weight32 - lr * (g + wd * weight32)
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", nondiff_inputs=(0, 1, 2, 3), num_outputs=3,
          num_visible_outputs=1, aux_updates={2: 1, 3: 2})
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, **kw):
    g = _prep_grad(grad.to(torch.float32), rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight32)
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("adam_update", nondiff_inputs=(0, 1, 2, 3), num_outputs=3,
          num_visible_outputs=1, aux_updates={2: 1, 3: 2})
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=True, **kw):
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    return (weight - lr * new_mean / (torch.sqrt(new_var) + epsilon),
            new_mean, new_var)


@register("rmsprop_update", nondiff_inputs=(0, 1, 2), num_outputs=2,
          num_visible_outputs=1, aux_updates={2: 1})
def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0, **kw):
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    w = weight - lr * g / torch.sqrt(new_n + epsilon)
    return _clip_weights(w, clip_weights), new_n


@register("rmspropalex_update", nondiff_inputs=(0, 1, 2, 3, 4),
          num_outputs=4, num_visible_outputs=1,
          aux_updates={2: 1, 3: 2, 4: 3})
def _rmspropalex_update(weight, grad, n, g_, delta, lr=0.001, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0, **kw):
    grd = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1 - gamma1) * torch.square(grd)
    new_g = gamma1 * g_ + (1 - gamma1) * grd
    new_delta = gamma2 * delta - lr * grd / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    w = weight + new_delta
    return _clip_weights(w, clip_weights), new_n, new_g, new_delta


@register("ftrl_update", nondiff_inputs=(0, 1, 2, 3), num_outputs=3,
          num_visible_outputs=1, aux_updates={2: 1, 3: 2})
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0, **kw):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    # times 1/lr where the JAX package divides by lr: on CUDA a tensor
    # divided by a host scalar is multiplied by its reciprocal, while a
    # multi-tensor division divides, so the fused update could round
    # otherwise; a product rounds alike everywhere
    inv_lr = 1.0 / lr
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) * inv_lr
    new_z = z + g - sigma * weight
    w = torch.where(
        torch.abs(new_z) <= lamda1,
        torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) * inv_lr + wd))
    return w, new_z, new_n


@register("signsgd_update", nondiff_inputs=(0, 1))
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, **kw):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register("signum_update", nondiff_inputs=(0, 1, 2), num_outputs=2,
          num_visible_outputs=1, aux_updates={2: 1})
def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0, **kw):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * g
    return weight - lr * (torch.sign(-new_mom) + wd * weight), new_mom
