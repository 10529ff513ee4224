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

It also holds the named collectives (``collective.py:79-147``: ``psum``,
``pmean``, ``pmax``, ``all_gather``, ``reduce_scatter``,
``ppermute_shift``, ``all_to_all``, ``axis_index``, ``axis_size``,
``barrier``, ``host_allreduce``).  Each acts over the process group of an
axis of the mesh bound by ``mesh.shard_map`` (or ``mesh.using_mesh``) on
this rank's block, and each is differentiable where the JAX package
differentiates through it: the gradient of ``psum`` is the ``psum`` of
the gradients, of ``all_gather`` their ``reduce_scatter`` and the other
way round, of a shift the opposite shift, of ``all_to_all`` the
all-to-all back.  ``copy_to_axis`` and ``reduce_from_axis`` are
Megatron's "f" and "g": identity one way and a sum over the axis the
other, which GSPMD derives in the JAX package.  Every rank of a group
issues the same collectives in the same order.

Under ``gloo`` a CUDA tensor goes through a collective as it is where
this torch's gloo takes it on CUDA (``GLOO_CUDA_OPS``); for the others it
is copied through pinned host buffers, each such call counted in
``collective_host_staged`` (its bytes in
``collective_host_staged_bytes``).  Under ``nccl`` nothing is staged.  A
ring exchange counts one ``collective_p2p``.  ``redistribute`` and
``redistribution_schedule`` (``:197``, ``:473``) come with the
checkpoint reshard.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..base import MXNetError
from .. import profiler
from . import mesh as mesh_mod
from . import multihost

__all__ = ["chunk_bytes", "refresh_from_env", "chunk_elems", "chunk_bounds",
           "chunked_reduce", "gather_home", "sum_copies",
           "psum", "pmean", "pmax", "all_gather", "reduce_scatter",
           "ppermute_shift", "all_to_all", "axis_index", "axis_size",
           "barrier", "host_allreduce", "copy_to_axis", "reduce_from_axis",
           "axis_group", "exchange", "ring_exchange", "GLOO_CUDA_OPS"]

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


# ---------------------------------------------------------------------------
# named collectives over the axes of the bound mesh
# ---------------------------------------------------------------------------

# The collectives this torch's gloo takes on CUDA tensors as they are
# (tools/torch_gloo_cuda_probe.py on the H100, torch 2.11.0+cu128): gloo
# reads a CUDA tensor's pointer as host memory in send/recv ("writev: Bad
# address", the rank aborts), so under gloo P2P copies a CUDA tensor
# through pinned host buffers.
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather_into_tensor",
                           "reduce_scatter_tensor", "all_to_all_single"})

_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def axis_group(axis_name):
    """The process group of ``axis_name`` on the bound mesh."""
    mesh = mesh_mod.current_mesh()
    if mesh is None:
        raise MXNetError("collective over %r: no mesh is bound (call inside "
                         "mesh.shard_map or mesh.using_mesh)" % (axis_name,))
    return mesh.group(axis_name)


def _axes(axis_name):
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


def _staged(op, group, tensors):
    """Whether ``op`` copies ``tensors`` through the host: CUDA tensors in
    a gloo group, for an op gloo does not take on CUDA."""
    return (any(t.is_cuda for t in tensors) and op not in GLOO_CUDA_OPS
            and dist.get_backend(group) == "gloo")


def _host(t):
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def _run(op, fn, group, outs, ins):
    """``fn(outs, ins)`` over ``group``, through pinned host copies where
    :func:`_staged` says so (each such call counted)."""
    if not _staged(op, group, outs + ins):
        fn(outs, ins)
        return
    profiler.bump("collective_host_staged")
    profiler.bump("collective_host_staged_bytes",
                  sum(t.numel() * t.element_size() for t in outs + ins))
    host_outs = [_host(t) for t in outs]
    fn(host_outs, [_host(t) for t in ins])
    for t, h in zip(outs, host_outs):
        t.copy_(h)


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if dist.get_world_size(group) > 1:
        _run("all_reduce",
             lambda o, i: dist.all_reduce(o[0], op=op, group=group),
             group, [out], [])
    return out


def _all_gather(x, group, dim):
    n = dist.get_world_size(group)
    if n == 1:
        return x.detach().clone()
    src = x.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _run("all_gather_into_tensor",
         lambda o, i: _all_gather_single(o[0], i[0], group=group),
         group, [out], [src])
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x, group, dim):
    n = dist.get_world_size(group)
    if n == 1:
        return x.detach().clone()
    src = x.detach().movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise MXNetError("reduce_scatter: dim %d of size %d does not divide "
                         "over %d ranks" % (dim, src.shape[0], n))
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _run("reduce_scatter_tensor",
         lambda o, i: _reduce_scatter_single(o[0], i[0], group=group),
         group, [out], [src])
    return out.movedim(0, dim).contiguous()


def _all_to_all(x, group, split_axis, concat_axis):
    n = dist.get_world_size(group)
    if n == 1:
        return x.detach().clone()
    src = x.detach().movedim(split_axis, 0).contiguous()
    if src.shape[0] % n:
        raise MXNetError("all_to_all: dim %d of size %d does not divide over "
                         "%d ranks" % (split_axis, src.shape[0], n))
    out = torch.empty_like(src)
    _run("all_to_all_single",
         lambda o, i: dist.all_to_all_single(o[0], i[0], group=group),
         group, [out], [src])
    return torch.cat([c.movedim(0, split_axis) for c in out.chunk(n, 0)],
                     dim=concat_axis)


def exchange(sends, recvs, group):
    """Point-to-point transfers in one ``batch_isend_irecv`` over
    ``group``: ``sends`` and ``recvs`` are ``(global rank, tensor)``; what
    arrives lands in the ``recvs`` tensors.  Counts one
    ``collective_p2p``."""
    if not sends and not recvs:
        return
    profiler.bump("collective_p2p")
    peers_out = [peer for peer, _ in sends]
    peers_in = [peer for peer, _ in recvs]

    def run(outs, ins):
        ops = [dist.P2POp(dist.isend, t, peer, group)
               for peer, t in zip(peers_out, ins)]
        ops += [dist.P2POp(dist.irecv, t, peer, group)
                for peer, t in zip(peers_in, outs)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    _run("batch_isend_irecv", run, group, [t for _, t in recvs],
         [t.detach().contiguous() for _, t in sends])


def ring_exchange(sends, group, shift=1):
    """Send each tensor of ``sends`` to the rank ``shift`` places on along
    ``group``'s ring and return what arrives from ``shift`` places back
    (new tensors of the same shapes), in one ``batch_isend_irecv``."""
    n = dist.get_world_size(group)
    sends = [t.detach().contiguous() for t in sends]
    if n == 1 or shift % n == 0:
        return [t.clone() for t in sends]
    ranks = dist.get_process_group_ranks(group)
    me = ranks.index(dist.get_rank())
    to, frm = ranks[(me + shift) % n], ranks[(me - shift) % n]
    recvs = [torch.empty_like(t) for t in sends]
    exchange([(to, t) for t in sends], [(frm, t) for t in recvs], group)
    return recvs


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return ring_exchange([x], group, shift)[0]

    @staticmethod
    def backward(ctx, g):
        return ring_exchange([g], ctx.group, -ctx.shift)[0], None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (_all_to_all(g, ctx.group, concat_axis, split_axis),
                None, None, None)


def psum(x, axis_name):
    """All-reduce sum over a mesh axis (or a tuple of axes)."""
    for a in _axes(axis_name):
        x = _AllReduce.apply(x, axis_group(a))
    return x


def pmean(x, axis_name):
    return psum(x, axis_name) / axis_size(axis_name)


def pmax(x, axis_name):
    """All-reduce max over a mesh axis (or axes); not differentiable, as in
    the JAX package."""
    x = x.detach()
    for a in _axes(axis_name):
        x = _all_reduce(x, axis_group(a), dist.ReduceOp.MAX)
    return x


def copy_to_axis(x, axis_name):
    """Megatron's "f": ``x`` unchanged, its gradient summed over the axis
    (where ``x`` feeds work split over the axis)."""
    for a in _axes(axis_name):
        x = _CopyTo.apply(x, axis_group(a))
    return x


def reduce_from_axis(x, axis_name):
    """Megatron's "g": the sum of ``x`` over the axis, its gradient passed
    through unchanged (every rank of the axis holds the whole sum)."""
    for a in _axes(axis_name):
        x = _ReduceFrom.apply(x, axis_group(a))
    return x


def all_gather(x, axis_name, axis=0, tiled=True):
    """The blocks of every rank of the axis joined along ``axis`` (tiled;
    ``tiled=False`` stacks them in a new leading dimension at ``axis``)."""
    if not tiled:
        return all_gather(x.unsqueeze(axis), axis_name, axis)
    return _AllGather.apply(x, axis_group(axis_name), axis)


def reduce_scatter(x, axis_name, axis=0):
    """Sum over the axis, then this rank's 1/n of ``axis`` (psum_scatter,
    tiled)."""
    return _ReduceScatter.apply(x, axis_group(axis_name), axis)


def ppermute_shift(x, axis_name, shift=1):
    """Rotate blocks around the axis's ring by ``shift``: a positive shift
    sends to the next-higher index."""
    return _Shift.apply(x, axis_group(axis_name), shift)


def all_to_all(x, axis_name, split_axis, concat_axis):
    """All-to-all, tiled: ``split_axis`` cut into n pieces, piece j to rank
    j, the pieces received joined along ``concat_axis`` in rank order."""
    return _AllToAll.apply(x, axis_group(axis_name), split_axis,
                           concat_axis)


def axis_index(axis_name):
    """This rank's index along the axis."""
    mesh = mesh_mod.current_mesh()
    if mesh is None:
        raise MXNetError("axis_index(%r): no mesh is bound" % (axis_name,))
    return mesh.axis_index(axis_name)


def axis_size(axis_name):
    """The number of ranks along the axis (or the product over a tuple)."""
    mesh = mesh_mod.current_mesh()
    if mesh is None:
        raise MXNetError("axis_size(%r): no mesh is bound" % (axis_name,))
    n = 1
    for a in _axes(axis_name):
        n *= mesh.shape[a]
    return n


def barrier(name="barrier"):
    """Block until every rank arrives (reference ``KVStore::Barrier``);
    ``name`` labels it, as in the JAX package."""
    multihost.barrier()


def host_allreduce(arrays):
    """The sum of per-device copies, on the first copy's device (the
    kvstore's local reduce), over the copies in their order."""
    if len(arrays) == 1:
        return arrays[0]
    dev = arrays[0].device
    return sum_copies([a.to(dev) for a in arrays])
