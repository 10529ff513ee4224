"""ZeRO-1 cross-replica weight-update sharding: the rule and the one-rank
update.

Counterpart of ``mxnet_tpu/parallel/zero.py`` ("Automatic Cross-Replica
Sharding of Weight Update in Data-Parallel Training", arXiv:2004.13336):
each of n data-parallel ranks would update 1/n of the rows of every weight
whose update can shard, and hold only that part of its optimizer state.
Here the rule that says which weights shard (:func:`zero1_update_spec`),
the update of a group of one rank, where nothing shards and the update
runs as it is (:func:`sharded_update`), and the state-size arithmetic
(:func:`state_bytes`).  A group of more than one rank needs the parallel
tier (reduce-scatter of the gradient, all-gather of the weight), which is
not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError

__all__ = ["zero1_update_spec", "sharded_update", "state_bytes"]


def zero1_update_spec(shape, replicated, ndata):
    """Whether a weight's update shards over a data group of ``ndata``
    ranks: the weight is ``replicated`` (not split by tensor parallelism),
    the group has more than one rank, and the leading dim divides evenly.
    The JAX package's function returns the PartitionSpec of that shard, or
    None where this one returns False."""
    shape = tuple(shape)
    return bool(replicated and shape and ndata > 1
                and shape[0] % ndata == 0)


def sharded_update(update_fn, p, g, state, hyper, group=None):
    """One update with ZeRO-1 placement: ``update_fn(p, g, state, hyper)
    -> (new_p, new_state)``, the pure optimizer core, over a weight or a
    list of weights.  ``group`` is a ``torch.distributed`` process group
    (anything with ``size()``).  For a group of one rank (or ``None``) no
    update shards, and ``update_fn`` runs unchanged, as the JAX package's
    does when ``zero1_update_spec`` gives None.  A larger group raises
    :class:`MXNetError`."""
    n = 1 if group is None else int(group.size())
    if n != 1:
        raise MXNetError("sharded_update: a data group of %d ranks shards "
                         "the update over them, which needs the parallel "
                         "tier (not ported yet); use a group of one rank"
                         % n)
    return update_fn(p, g, state, hyper)


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
