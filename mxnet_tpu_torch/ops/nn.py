"""Neural-network layer ops: ``FullyConnected``, ``Convolution``,
``Pooling``, ``BatchNorm``, ``Activation`` and ``SoftmaxOutput``.

Counterpart of ``mxnet_tpu/ops/nn.py`` (``FullyConnected``:39,
``Convolution``:56, ``Pooling``:106, ``BatchNorm``:174,
``Activation``:243, ``SoftmaxOutput``:363 with its semantic backward
``_softmax_output_bwd``:314).  The JAX package leaves these products and
windows to XLA, outside any Pallas kernel, so here they are
``torch.matmul`` and ``torch.nn.functional``'s convolutions and pools
(cuBLAS and cuDNN on the card).  Layout is MXNet's: NCHW data, OIHW
weights.  ``BatchNorm`` is the JAX formula written in torch ops, not
``F.batch_norm``: MXNet's momentum weighs the old statistic, and the
moving variance takes the biased batch variance.  ``SoftmaxOutput``
keeps MXNet's semantic gradient: ``(softmax - onehot) * grad_scale /
norm`` whatever the head gradient is, and zeros for the label.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .elemwise import _max0
from .registry import register


@register("FullyConnected")
def _fully_connected(data, weight, *maybe_bias, num_hidden=None, no_bias=False,
                     flatten=True, **kw):
    x = data.reshape((data.shape[0], -1)) if flatten else data
    out = torch.matmul(x, weight.t())
    if not no_bias and maybe_bias:
        out = out + maybe_bias[0]
    return out


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", aliases=["Convolution_v1"])
def _convolution(data, weight, *maybe_bias, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=1, num_group=1, no_bias=False, **kw):
    nd = len(kernel)
    bias = maybe_bias[0] if maybe_bias and not no_bias else None
    return _CONV[nd](data, weight, bias, _tup(stride or 1, nd),
                     _tup(pad or 0, nd), _tup(dilate or 1, nd),
                     int(num_group))


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _window_sum(x, kernel, stride):
    """Sum over each window of an already padded ``x`` (no padding)."""
    nd = len(kernel)
    if nd == 1:  # avg_pool1d takes no divisor_override
        return _window_sum(x.unsqueeze(-1), kernel + (1,),
                           stride + (1,)).squeeze(-1)
    return _AVG_POOL[nd](x, kernel, stride, 0, divisor_override=1)


@register("Pooling", aliases=["Pooling_v1"])
def _pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
             pad=(), pooling_convention="valid", count_include_pad=True,
             **kw):
    nd = data.ndim - 2
    if global_pool:
        kernel, stride, pad = tuple(data.shape[2:]), (1,) * nd, (0,) * nd
    kernel = _tup(kernel, nd)
    stride = _tup(stride or 1, nd)
    pad = _tup(pad or 0, nd)
    if pool_type not in ("max", "avg", "sum"):
        raise ValueError("unknown pool_type %s" % pool_type)
    extra = [0] * nd
    if pooling_convention == "full":
        # the JAX package's ceil mode (ops/nn.py:120-133): pad the high
        # side so that the last partial window counts.  torch's ceil_mode
        # drops a window that would start in the right padding, so the
        # padding is made here and the pool itself runs unpadded
        for i in range(nd):
            size = data.shape[2 + i]
            out = math.ceil((size + 2 * pad[i] - kernel[i]) / stride[i]) + 1
            extra[i] = max(0, (out - 1) * stride[i] + kernel[i] - size
                           - 2 * pad[i])
    if not any(extra) and all(2 * p <= k for p, k in zip(pad, kernel)):
        # torch pads these itself, as the JAX package does: -inf for max,
        # zeros counted (count_include_pad) or not for avg and sum
        if pool_type == "max":
            return _MAX_POOL[nd](data, kernel, stride, pad)
        if nd in _AVG_POOL:
            return _AVG_POOL[nd](
                data, kernel, stride, pad,
                count_include_pad=bool(count_include_pad),
                divisor_override=1 if pool_type == "sum" else None)
    # F.pad takes (low, high) pairs from the last axis back
    widths = [w for i in reversed(range(nd))
              for w in (pad[i], pad[i] + extra[i])]
    if pool_type == "max":
        fill = -math.inf if data.is_floating_point() \
            else torch.iinfo(data.dtype).min
        return _MAX_POOL[nd](F.pad(data, widths, value=fill), kernel, stride)
    total = _window_sum(F.pad(data, widths), kernel, stride)
    if pool_type == "sum":
        return total
    if count_include_pad:
        return total / float(math.prod(kernel))
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    return total / _window_sum(F.pad(ones, widths), kernel, stride)


@register("BatchNorm", aliases=["BatchNorm_v1", "CuDNNBatchNorm"],
          num_outputs=3, num_visible_outputs=1, nondiff_inputs=(3, 4),
          aux_updates={3: 1, 4: 2}, takes_mode=True)
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                axis=1, train_mode=False, **kw):
    ax = axis % data.ndim
    red = tuple(i for i in range(data.ndim) if i != ax)
    shape = [1] * data.ndim
    shape[ax] = data.shape[ax]
    # fix_gamma: the op scales by ones, so gamma's gradient is zero
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if train_mode and not use_global_stats:
        # the biased variance, as jnp.var; MXNet's momentum weighs the old
        # statistic (torch's F.batch_norm means the opposite by momentum)
        mean = data.mean(dim=red)
        var = data.var(dim=red, unbiased=False)
        new_mm = moving_mean * momentum + mean.detach() * (1 - momentum)
        new_mv = moving_var * momentum + var.detach() * (1 - momentum)
    else:
        mean, var = moving_mean, moving_var
        new_mm, new_mv = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    out = (data - mean.reshape(shape)) * inv.reshape(shape) \
        * g.reshape(shape) + beta.reshape(shape)
    return out, new_mm, new_mv


_ACT = {
    "relu": _max0,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": torch.nn.functional.softplus,
    "softsign": torch.nn.functional.softsign,
}


@register("Activation")
def _activation(data, act_type="relu", **kw):
    if act_type not in _ACT:
        raise ValueError("unknown act_type %s" % act_type)
    return _ACT[act_type](data)


def _softmax_fwd(data, multi_output=False, preserve_shape=False):
    if multi_output:
        return torch.softmax(data, dim=1)
    if preserve_shape:
        return torch.softmax(data, dim=-1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


def _one_hot(label, c, dtype):
    lab = label.to(torch.int64)
    # jax.nn.one_hot gives an all-zero row for a class outside [0, c)
    valid = (lab >= 0) & (lab < c)
    oh = torch.nn.functional.one_hot(torch.where(valid, lab, 0), c)
    return (oh * valid[..., None]).to(dtype)


def _softmax_output_bwd(out_grads, inputs, outputs, attrs):
    data, label = inputs[0], inputs[1]
    out = outputs[0]
    grad_scale = attrs.get("grad_scale", 1.0)
    ignore_label = attrs.get("ignore_label", -1.0)
    use_ignore = attrs.get("use_ignore", False)
    multi_output = attrs.get("multi_output", False)
    normalization = attrs.get("normalization", "null")
    smooth_alpha = attrs.get("smooth_alpha", 0.0)
    if not multi_output and label.ndim == data.ndim:  # one-hot/dense label
        grad = out - label
        norm = float(data.shape[0]) if normalization == "batch" else 1.0
        return (grad * (grad_scale / norm), torch.zeros_like(label))
    c = data.shape[1] if multi_output else data.shape[-1]
    lab = label.to(torch.int64)
    oh = _one_hot(label, c, data.dtype)
    if multi_output:  # data (N, C, ...), label (N, ...)
        oh = torch.movedim(oh, -1, 1)
    if smooth_alpha:
        oh = oh * (1 - smooth_alpha) + smooth_alpha / (c - 1) * (1 - oh)
    grad = out - oh
    valid = torch.ones(lab.shape, dtype=data.dtype, device=data.device)
    if use_ignore:
        valid = (lab != int(ignore_label)).to(data.dtype)
        grad = grad * (valid[:, None] if multi_output else valid[..., None])
    norm = 1.0
    if normalization == "valid":
        norm = torch.clamp_min(valid.sum(), 1.0)
    elif normalization == "batch":
        norm = float(data.shape[0])
    return (grad * (grad_scale / norm), torch.zeros_like(label))


@register("SoftmaxOutput", aliases=["Softmax"], nondiff_inputs=(1,),
          custom_vjp=_softmax_output_bwd)
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False, preserve_shape=False,
                    normalization="null", out_grad=False, smooth_alpha=0.0,
                    **kw):
    return _softmax_fwd(data, multi_output, preserve_shape)
