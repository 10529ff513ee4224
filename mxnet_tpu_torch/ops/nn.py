"""Neural-network layer ops: ``FullyConnected``, ``Activation`` and
``SoftmaxOutput``.

Counterpart of ``mxnet_tpu/ops/nn.py`` (``FullyConnected``:39,
``Activation``:243, ``SoftmaxOutput``:363 with its semantic backward
``_softmax_output_bwd``:314).  The JAX package leaves the product of
``FullyConnected`` to XLA, outside any Pallas kernel, so here it is
``torch.matmul`` (cuBLAS on the card).  ``SoftmaxOutput`` keeps MXNet's
semantic gradient: ``(softmax - onehot) * grad_scale / norm`` whatever
the head gradient is, and zeros for the label.
"""
from __future__ import annotations

import torch

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
