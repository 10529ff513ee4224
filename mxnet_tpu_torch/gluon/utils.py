"""Gluon utilities: ``split_data``, ``split_and_load`` and
``clip_global_norm``.

Counterpart of ``mxnet_tpu/gluon/utils.py`` (``split_data``:18,
``split_and_load``:44, ``clip_global_norm``:88).  ``split_and_load``
takes a list of contexts as the reference does; one context loads the
whole batch there, and several raise ``MXNetError`` (ROADMAP A.7).
``clip_global_norm`` takes the 2-norm over all the arrays in fp32 and
scales them in place when it exceeds ``max_norm``, in a few device ops
and one read of the norm; arrays that are not all finite are left as
they are, and their norm is returned.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .. import ndarray as nd

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of an NDArray along ``batch_axis``."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            "Too many slices for data with shape %s. Arguments are "
            "num_slice=%d and batch_axis=%d." % (
                str(data.shape), num_slice, batch_axis))
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices "
            "along axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data."
            % (str(data.shape), num_slice, batch_axis, num_slice))
    step = size // num_slice
    return [nd.slice_axis(data, axis=batch_axis, begin=i * step,
                          end=(i + 1) * step if i < num_slice - 1 or
                          even_split else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """The batch ``data`` (an NDArray or array-like) loaded on the one
    context of ``ctx_list``, as a list of one NDArray."""
    if len(ctx_list) != 1:
        raise MXNetError("split_and_load over %d contexts: several contexts "
                         "are not ported yet (ROADMAP A.7)" % len(ctx_list))
    if not isinstance(data, nd.NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    return [data.as_in_context(ctx_list[0])]


def clip_global_norm(arrays, max_norm):
    """Scale ``arrays`` in place so that their joint 2-norm is at most
    ``max_norm``; returns the norm before clipping, as a float."""
    assert len(arrays) > 0
    with torch.no_grad():
        raws = [a._data for a in arrays]
        flat = [r.reshape(-1).to(torch.float32) for r in raws]
        total = torch.dot(flat[0], flat[0])
        for f in flat[1:]:
            total = total + torch.dot(f, f)
        norm = torch.sqrt(total)
        finite = torch.stack([torch.isfinite(r).all() for r in raws]).all()
        scale = max_norm / (norm + 1e-8)
        scale = torch.where(finite & (scale < 1.0), scale,
                            torch.ones_like(scale))
        for arr, raw in zip(arrays, raws):
            arr._set_data(raw * scale.to(raw.dtype))
    return float(norm)
