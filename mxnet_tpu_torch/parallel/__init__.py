"""Parallel tier of the PyTorch package: one process a rank, over
``torch.distributed`` (counterpart of ``mxnet_tpu/parallel/``).

- ``multihost``: the ranks' process group from the launcher's
  environment (``init_from_env``);
- ``mesh``: named axes over the ranks (``make_mesh``, ``shard_put``,
  ``shard_map``, the ``MXNET_MESH_*`` default);
- ``collective``: the named collectives over a mesh axis, differentiable
  where the JAX package's are, and the kvstore's chunked sum;
- ``ring_attention``: exact attention over a sequence-sharded axis;
- ``zero``: the ZeRO-1 update over a data group of any size;
- ``pipeline``: the GPipe schedule over a ``pipe`` axis.

``ShardedTrainer``, ``block_pure_fn`` and ``sharded_data``
(``mxnet_tpu/parallel/sharded.py``) are not ported yet.
"""
from .mesh import (make_mesh, auto_mesh, factor_devices, current_mesh,
                   using_mesh, shard_map, named_sharding, filter_spec,
                   replicated, shard_put, shard_get, jit_sharded,
                   multihost_mesh, mesh_from_env, default_mesh, topology)
from .collective import (psum, pmean, pmax, all_gather, reduce_scatter,
                         ppermute_shift, all_to_all, axis_index, axis_size,
                         barrier, host_allreduce)
from .zero import zero1_update_spec
from .ring_attention import (ring_attention, local_attention,
                             ring_attention_sharded)
from .pipeline import pipeline_apply
from . import collective, mesh, multihost, pipeline, zero
from .multihost import init_from_env

__all__ = [
    "make_mesh", "auto_mesh", "factor_devices", "current_mesh", "using_mesh",
    "shard_map", "named_sharding", "filter_spec", "replicated", "shard_put",
    "shard_get", "jit_sharded", "multihost_mesh", "mesh_from_env",
    "default_mesh", "topology",
    "psum", "pmean", "pmax", "all_gather", "reduce_scatter", "ppermute_shift",
    "all_to_all", "axis_index", "axis_size", "barrier", "host_allreduce",
    "zero1_update_spec",
    "ring_attention", "local_attention", "ring_attention_sharded",
    "pipeline_apply",
    "collective", "mesh", "multihost", "pipeline", "zero", "init_from_env",
]
