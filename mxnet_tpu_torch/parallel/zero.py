"""ZeRO-1 cross-replica weight-update sharding.

Counterpart of ``mxnet_tpu/parallel/zero.py:39-123`` ("Automatic
Cross-Replica Sharding of Weight Update in Data-Parallel Training",
arXiv:2004.13336): each of n data-parallel ranks updates 1/n of the rows
of every weight whose update can shard, and holds only those rows of its
optimizer state.  The JAX package gets the reduce-scatter / 1-of-n update
/ all-gather from sharding constraints; here :func:`sharded_update` does
them over a ``torch.distributed`` process group, for each weight that
:func:`zero1_update_spec` shards:

1. reduce-scatter the gradient's rows over the group;
2. update this rank's rows (``update_fn`` on row slices, with the state
   held for those rows only);
3. all-gather the weight's rows.

Any other weight takes the all-reduced gradient and the replicated update.
An elementwise update on a row slice gives the bits it gives on the whole
array, so given one reduced gradient the sharded update is the replicated
one bit for bit; a reduce-scatter may add the ranks' gradients in another
order than an all-reduce, so end to end they agree to the sum's rounding.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..base import MXNetError
from . import collective

__all__ = ["zero1_update_spec", "zero1_axis_mesh", "update_sharding",
           "sharded_update", "shard_state_tree_spec", "state_bytes",
           "sharded_state", "group_size"]


def zero1_update_spec(shape, replicated, ndata):
    """Whether a weight's update shards over a data group of ``ndata``
    ranks: the weight is ``replicated`` (not split by tensor parallelism),
    the group has more than one rank, and the leading dim divides evenly.
    The JAX package's function returns the PartitionSpec of that shard, or
    None where this one returns False."""
    shape = tuple(shape)
    return bool(replicated and shape and ndata > 1
                and shape[0] % ndata == 0)


def zero1_axis_mesh(n_shards, axis="zero", ranks=None, device=None):
    """A 1-D mesh over the first ``n_shards`` ranks: the replica axis a
    sharded update lives on."""
    from . import mesh as mesh_mod
    if ranks is None:
        ranks = list(range(dist.get_world_size()))
    n = max(1, min(int(n_shards), len(ranks)))
    return mesh_mod.make_mesh({axis: n}, ranks[:n], device)


def update_sharding(mesh, shape, axis, replicated=True):
    """The process group one weight's update shards over on ``mesh``'s
    ``axis``, or None for the replicated update (a weight split by tensor
    parallelism, an indivisible leading dim, a scalar, or a mesh without
    the axis)."""
    n = mesh.shape.get(axis, 1)
    if not zero1_update_spec(shape, replicated, n):
        return None
    return mesh.group(axis)


def shard_state_tree_spec(state_leaf_shape, weight_shape, upd_sharding,
                          replicated):
    """Placement of one optimizer-state leaf: weight-shaped leaves follow
    the weight's update sharding, other (scalar) state stays
    ``replicated``."""
    if upd_sharding is not None \
            and tuple(state_leaf_shape) == tuple(weight_shape):
        return upd_sharding
    return replicated


def group_size(group):
    """The ranks of a data group: 1 for None.  Anything other than a
    ``torch.distributed`` process group raises, unless its ``size()`` is
    1 (a group of one rank, where nothing moves)."""
    if group is None:
        return 1
    if isinstance(group, dist.ProcessGroup):
        return dist.get_world_size(group)
    if group.size() == 1:
        return 1
    raise MXNetError("ZeRO-1: a data group of %d ranks must be a "
                     "torch.distributed process group, got %r"
                     % (group.size(), group))


def _rows(group, rows):
    n = dist.get_world_size(group)
    r = dist.get_group_rank(group, dist.get_rank())
    per = rows // n
    return slice(r * per, (r + 1) * per)


def sharded_state(t, group):
    """This rank's rows of a weight-shaped state tensor ``t`` (a copy), or
    ``t`` itself where ``group`` is None (the replicated update)."""
    if group_size(group) == 1:
        return t
    return t[_rows(group, t.shape[0])].clone()


def sharded_update(update_fn, p, g, state, hyper, group=None,
                   replicated=None):
    """One ZeRO-1 update: ``update_fn(p, g, state, hyper) -> (new_p,
    new_state)`` is the optimizer's elementwise core, over a weight or
    over lists of weights, as ``p``, ``g`` and ``state`` are given.

    ``g`` is this rank's gradient, not yet summed over ``group``, the
    data-parallel ``torch.distributed`` process group (None: one rank,
    where nothing shards and ``update_fn`` runs on ``g`` as it is).
    ``replicated`` (a bool, or one a weight; default True) says which
    weights are whole on every rank of the group.  A weight that
    :func:`zero1_update_spec` shards has as state this rank's rows
    (:func:`sharded_state`), and comes back as a new tensor, gathered;
    the others take the all-reduced gradient and ``update_fn``'s result.
    Every rank of the group calls it with the same weights in the same
    order."""
    n = group_size(group)
    if n == 1:
        return update_fn(p, g, state, hyper)
    if isinstance(p, torch.Tensor):
        rep = True if replicated is None else bool(replicated)
        if not zero1_update_spec(p.shape, rep, n):
            return update_fn(p, collective._all_reduce(g, group), state,
                             hyper)
        rows = p[_rows(group, p.shape[0])].clone()
        new_rows, new_state = update_fn(
            rows, collective._reduce_scatter(g, group, 0), state, hyper)
        return collective._all_gather(new_rows, group, 0), new_state
    ps, gs, ss = list(p), list(g), list(state)
    reps = [True] * len(ps) if replicated is None else list(replicated)
    sharded = [zero1_update_spec(q.shape, rep, n)
               for q, rep in zip(ps, reps)]
    new_ps, new_ss = list(ps), list(ss)
    # the weights that shard: reduce-scatter, update the rows, all-gather
    idx = [i for i, sh in enumerate(sharded) if sh]
    if idx:
        rows = [ps[i][_rows(group, ps[i].shape[0])].clone() for i in idx]
        grads = [collective._reduce_scatter(gs[i], group, 0) for i in idx]
        new_rows, states = update_fn(rows, grads, [ss[i] for i in idx],
                                     hyper)
        for j, i in enumerate(idx):
            new_ps[i] = collective._all_gather(new_rows[j], group, 0)
            new_ss[i] = states[j]
    # the others: the all-reduced gradient, the replicated update
    rest = [i for i, sh in enumerate(sharded) if not sh]
    if rest:
        upd, states = update_fn(
            [ps[i] for i in rest],
            [collective._all_reduce(gs[i], group) for i in rest],
            [ss[i] for i in rest], hyper)
        for j, i in enumerate(rest):
            new_ps[i], new_ss[i] = upd[j], states[j]
    return new_ps, new_ss


def state_bytes(leaves, n_shards):
    """(per_device_bytes, replicated_bytes) for a list of (leaf_shape,
    leaf_dtype, is_sharded) descriptors, the ``zero_optimizer_bytes_*``
    arithmetic of the JAX package."""
    per_dev = total = 0
    n = max(1, int(n_shards))
    for shape, dtype, sharded in leaves:
        nbytes = (int(np.prod(shape, dtype=np.int64))
                  * np.dtype(dtype).itemsize)
        total += nbytes
        per_dev += nbytes // n if sharded else nbytes
    return per_dev, total
