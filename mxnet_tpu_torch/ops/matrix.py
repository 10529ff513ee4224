"""Shape and indexing ops: ``Reshape``, ``Flatten``, ``SwapAxis``,
``reshape_like``, ``Concat``, ``slice_axis`` and ``pick``.

Counterpart of ``mxnet_tpu/ops/matrix.py:24-76``, ``SwapAxis``:91,
``reshape_like``:96, ``Concat``:101, ``slice_axis``:144 and ``pick``:276,
with MXNet's special ``Reshape`` codes (0 copy, -1 infer, -2 copy the
rest, -3 merge two, -4 split one) and ``reverse``.
"""
from __future__ import annotations

import math

import torch

from .registry import register


def _reshape_target(src, shape):
    out, src_i, infer_idx, i = [], 0, None, 0
    while i < len(shape):
        s = shape[i]
        if s > 0:
            out.append(s)
            src_i += 1
        elif s == 0:  # copy dim
            out.append(src[src_i])
            src_i += 1
        elif s == -1:  # infer
            infer_idx = len(out)
            out.append(1)
            src_i += 1
        elif s == -2:  # copy all remaining
            out.extend(src[src_i:])
            src_i = len(src)
        elif s == -3:  # merge two dims
            out.append(src[src_i] * src[src_i + 1])
            src_i += 2
        elif s == -4:  # split dim into next two shape values
            a, b = shape[i + 1], shape[i + 2]
            d = src[src_i]
            if a == -1:
                a = d // b
            if b == -1:
                b = d // a
            out.extend([a, b])
            src_i += 1
            i += 2
        i += 1
    if infer_idx is not None:
        known = math.prod(d for j, d in enumerate(out) if j != infer_idx)
        out[infer_idx] = math.prod(src) // max(known, 1)
    return out


@register("Reshape", aliases=["reshape"])
def _reshape(x, shape=None, reverse=False, target_shape=None, **kw):
    if shape is None and target_shape is not None:  # legacy attr
        return x.reshape(tuple(target_shape))
    src, shape = list(x.shape), tuple(shape)
    if reverse:
        out = _reshape_target(src[::-1], shape[::-1])[::-1]
    else:
        out = _reshape_target(src, shape)
    return x.reshape(tuple(out))


@register("Flatten", aliases=["flatten"])
def _flatten(x, **kw):
    return x.reshape((x.shape[0], -1))


@register("Concat", aliases=["concat"])
def _concat(*args, dim=1, num_args=None, **kw):
    return torch.cat(args, dim=dim)


@register("SwapAxis", aliases=["swapaxes"])
def _swapaxes(x, dim1=0, dim2=0, **kw):
    return torch.swapaxes(x, dim1, dim2)


@register("reshape_like", nondiff_inputs=(1,))
def _reshape_like(x, like, **kw):
    return x.reshape(like.shape)


@register("slice_axis")
def _slice_axis(x, axis=0, begin=0, end=None, **kw):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(begin, end)
    return x[tuple(idx)]


@register("pick", nondiff_inputs=(1,))
def _pick(x, index, axis=-1, keepdims=False, mode="clip", **kw):
    """``x``'s entries at ``index`` along ``axis``; an index outside the
    axis is clipped into it (MXNet's ``mode="clip"``)."""
    ax = axis % x.ndim
    idx = index.to(torch.int64).clamp(0, x.shape[ax] - 1).unsqueeze(ax)
    out = torch.gather(x, ax, idx)
    return out if keepdims else out.squeeze(ax)
