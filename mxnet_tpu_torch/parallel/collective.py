"""Chunked reductions: a sum over several copies of a flat payload, one
chunk at a time.

Counterpart of the parts of ``mxnet_tpu/parallel/collective.py`` that the
kvstore's bucketed round uses (``chunk_bytes`` :170, ``chunk_bounds``
:179, ``chunked_reduce`` :302, ``gather_home`` :430).  A bucket that holds
one tensor larger than ``MXNET_OVERLAP_CHUNK_BYTES`` (default 1 MiB; read
at import, :func:`refresh_from_env` reads it again) is summed chunk by
chunk into its output, so the copies are never stacked whole.  Each
chunk's sum counts as one program (``collective_chunk_programs`` and
``program_calls``), as each chunk is one program in the JAX package.
The sum of each element runs over the copies in their order, so the
result is bit for bit that of one whole sum.
"""
from __future__ import annotations

import os

import torch

from .. import profiler

__all__ = ["chunk_bytes", "refresh_from_env", "chunk_elems", "chunk_bounds",
           "chunked_reduce", "gather_home", "sum_copies"]

_DEFAULT_CHUNK_BYTES = 1 << 20


def _env_chunk_bytes():
    try:
        return max(1, int(os.environ.get("MXNET_OVERLAP_CHUNK_BYTES",
                                         _DEFAULT_CHUNK_BYTES)))
    except ValueError:
        return _DEFAULT_CHUNK_BYTES


_CHUNK_BYTES = _env_chunk_bytes()


def refresh_from_env():
    """Read ``MXNET_OVERLAP_CHUNK_BYTES`` again."""
    global _CHUNK_BYTES
    _CHUNK_BYTES = _env_chunk_bytes()


def chunk_bytes():
    return _CHUNK_BYTES


def chunk_elems(dtype, limit=None):
    """Elements of ``dtype`` (a ``torch.dtype``) in one chunk."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return max(1, int(limit or _CHUNK_BYTES) // itemsize)


def chunk_bounds(n_elems, n_chunk):
    """``[(lo, hi), ...]`` covering ``[0, n_elems)`` in steps of
    ``n_chunk``; the last chunk carries the uneven tail."""
    n_elems, n_chunk = int(n_elems), max(1, int(n_chunk))
    return [(lo, min(lo + n_chunk, n_elems))
            for lo in range(0, n_elems, n_chunk)]


def sum_copies(tensors, out=None):
    """The elementwise sum of same-shaped tensors on one device, over the
    copies in their order (into ``out`` where given)."""
    return torch.sum(torch.stack(tensors), dim=0, out=out)


def chunked_reduce(flats, limit=None):
    """The sum of same-length 1-D tensors on one device, chunk by chunk."""
    flats = list(flats)
    if len(flats) == 1:
        return flats[0]
    n = int(flats[0].shape[0])
    out = torch.empty_like(flats[0])
    for lo, hi in chunk_bounds(n, chunk_elems(flats[0].dtype, limit)):
        profiler.bump("collective_chunk_programs")
        profiler.bump("program_calls")
        sum_copies([f[lo:hi] for f in flats], out=out[lo:hi])
    return out


def gather_home(shards, device):
    """Row blocks (on any devices) joined along axis 0 on ``device``."""
    profiler.bump("collective_gather_home")
    return torch.cat([s.to(device) for s in shards], dim=0)
