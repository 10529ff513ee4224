"""Reductions and broadcasts.

Counterpart of ``mxnet_tpu/ops/reduce.py:15-101``: ``sum``, ``mean``,
``prod``, ``nansum``, ``nanprod``, ``max`` and ``min`` (with the
``sum_axis``/``max_axis``/``min_axis`` aliases), ``argmax``/``argmin``/
``argmax_channel``, ``norm``, ``_square_sum`` and
``broadcast_axis``/``_axes``/``_to``/``_like``.  MXNet reduce attrs
kept: ``axis`` (None = all, negative counted from the end), ``keepdims``,
``exclude`` (reduce over the complement of ``axis``).

``max``/``min`` are ``amax``/``amin``, whose gradient splits evenly
between tied maxima as ``jnp.max``'s does.  ``argmax``/``argmin`` return
the index in the input's dtype, as the JAX package does (``.astype(
x.dtype)``): in bf16 they cannot count past 256.
"""
from __future__ import annotations

import torch

from .registry import register


def _norm_axis(axis, ndim, exclude=False):
    if axis is None:
        ax = tuple(range(ndim))
    elif isinstance(axis, int):
        ax = (axis % ndim,)
    else:
        ax = tuple(a % ndim for a in axis)
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


def _prod(x, dim, keepdim):
    """``torch.prod`` over several axes, one at a time (it takes one)."""
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=True)
    return x if keepdim else x.squeeze(dim)


def _nansum(x, dim, keepdim):
    """``jnp.nansum``: the sum with NaNs as zeros (``torch.sum``, which
    accumulates 16-bit types in fp32, as XLA does)."""
    return torch.sum(torch.where(torch.isnan(x), torch.zeros_like(x), x),
                     dim=dim, keepdim=keepdim)


def _nanprod(x, dim, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim,
                 keepdim)


def _mk_reduce(fn):
    def red(x, axis=None, keepdims=False, exclude=False, **kw):
        ax = _norm_axis(axis, x.ndim, exclude)
        if not ax:  # jnp reduces over no axis to the input itself
            return x
        return fn(x, dim=ax, keepdim=bool(keepdims))
    return red


for _n, _fn in {
    "sum": torch.sum, "mean": torch.mean, "prod": _prod,
    "nansum": _nansum, "nanprod": _nanprod,
    "max": torch.amax, "min": torch.amin,
}.items():
    register(_n, aliases=["%s_axis" % _n] if _n in ("sum", "max", "min")
             else [])(_mk_reduce(_fn))


def _mk_arg_reduce(fn):
    def red(x, axis=None, keepdims=False, **kw):
        if axis is None:
            out = fn(x.reshape(-1), dim=0)
            if keepdims:
                out = out.reshape((1,) * x.ndim)
            return out.to(x.dtype)
        return fn(x, dim=int(axis), keepdim=bool(keepdims)).to(x.dtype)
    return red


register("argmax")(_mk_arg_reduce(torch.argmax))
register("argmin")(_mk_arg_reduce(torch.argmin))


@register("argmax_channel")
def _argmax_channel(x, **kw):
    return torch.argmax(x, dim=1).to(x.dtype)


@register("norm")
def _norm(x, ord=2, axis=None, keepdims=False, **kw):
    if axis is None:
        return torch.sqrt(torch.sum(torch.square(x))).reshape((1,))
    ax = axis if isinstance(axis, int) else tuple(axis)
    if ord == 1:
        return torch.sum(torch.abs(x), dim=ax, keepdim=bool(keepdims))
    return torch.sqrt(torch.sum(torch.square(x), dim=ax,
                                keepdim=bool(keepdims)))


@register("_square_sum")
def _square_sum(x, axis=None, keepdims=False, **kw):
    ax = _norm_axis(axis, x.ndim)
    return torch.sum(torch.square(x), dim=ax, keepdim=bool(keepdims))


@register("broadcast_axis", aliases=["broadcast_axes"])
def _broadcast_axis(x, axis=(), size=(), **kw):
    if isinstance(axis, int):
        axis, size = (axis,), (size,)
    shape = list(x.shape)
    for a, s in zip(axis, size):
        shape[a] = s
    return torch.broadcast_to(x, tuple(shape))


@register("broadcast_to")
def _broadcast_to(x, shape=(), **kw):
    # MXNet's 0 keeps the input's dim
    tgt = tuple(x.shape[i] if s == 0 else s for i, s in enumerate(shape))
    return torch.broadcast_to(x, tgt)


@register("broadcast_like", nondiff_inputs=(1,))
def _broadcast_like(x, like, **kw):
    return torch.broadcast_to(x, like.shape)
