"""Reductions.

Counterpart of ``mxnet_tpu/ops/reduce.py:15-39`` (``sum``, ``mean``).
MXNet reduce attrs kept: ``axis`` (None = all), ``keepdims``,
``exclude`` (reduce over the complement of ``axis``).
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


def _mk_reduce(fn):
    def red(x, axis=None, keepdims=False, exclude=False, **kw):
        ax = _norm_axis(axis, x.ndim, exclude)
        if not ax:  # jnp reduces over no axis to the input itself
            return x
        return fn(x, dim=ax, keepdim=bool(keepdims))
    return red


register("sum", aliases=["sum_axis"])(_mk_reduce(torch.sum))
register("mean")(_mk_reduce(torch.mean))
