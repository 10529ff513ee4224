"""The rank mesh: the sharding substrate of the parallel tier.

Counterpart of ``mxnet_tpu/parallel/mesh.py:57-363``.  The JAX package is
single-controller: one process holds a ``jax.sharding.Mesh`` of devices
and every shard of every array.  This package runs one process a rank
(SPMD, over ``torch.distributed``), so a :class:`Mesh` lays named axes
over the ranks of the default process group, not over devices: it wraps a
``torch.distributed.device_mesh.DeviceMesh`` with the axis names, holds
one process group for each axis and this rank's coordinates, and every
entry point takes and returns **this rank's block** of a global array.
:func:`shard_put` and :func:`shard_get` convert between a global numpy
array and that block, from the mesh's coordinates.

Building a mesh creates its process groups, a collective call over the
whole default group: every rank builds the same meshes in the same order.
A mesh may cover the first ranks only (``ranks=``); a rank outside it has
no coordinate and may not place blocks on it.

A partition spec is a tuple of axis names or ``None`` (one entry a
dimension), as ``P`` is.  :func:`shard_map` calls a function on this
rank's blocks with the mesh's axis names bound, so the collectives of
``collective`` resolve an axis name to its group.  ``MXNET_MESH_SHAPE``
and ``MXNET_MESH_SPAN_HOSTS`` select a default mesh with the JAX
package's syntax (read at import; :func:`refresh_from_env` reads them
again).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..base import MXNetError
from .. import profiler
from ..context import as_device
from . import multihost

__all__ = ["Mesh", "NamedSharding", "make_mesh", "auto_mesh",
           "factor_devices", "current_mesh", "using_mesh", "shard_map",
           "filter_spec", "named_sharding", "replicated", "shard_put",
           "shard_get", "block_slices", "jit_sharded", "multihost_mesh",
           "mesh_from_env", "default_mesh", "topology", "refresh_from_env"]

_tls = threading.local()


class Mesh:
    """Named axes over ranks of the default process group.

    ``shape`` is ``{axis: size}`` in axis order; ``ranks`` the global
    ranks as an array of that shape; ``coordinate`` this rank's
    ``{axis: index}`` (None outside the mesh); ``device`` where this
    rank's blocks live.  ``group(axis)`` is the process group of this
    rank's line along ``axis``."""

    def __init__(self, axis_shapes, ranks, device):
        self.axis_names = tuple(axis_shapes)
        self.shape = dict(axis_shapes)
        sizes = [self.shape[a] for a in self.axis_names]
        self.ranks = np.asarray(ranks, dtype=np.int64).reshape(sizes)
        self.device = device
        self.device_mesh = DeviceMesh(
            device.type, torch.as_tensor(self.ranks),
            mesh_dim_names=self.axis_names)
        coord = self.device_mesh.get_coordinate()
        self.coordinate = (None if coord is None
                           else dict(zip(self.axis_names, coord)))
        self._groups = ({} if coord is None else
                        {a: self.device_mesh.get_group(a)
                         for a in self.axis_names})

    def _member(self, what):
        if self.coordinate is None:
            raise MXNetError("%s: rank %d is not in the mesh %s (ranks %s)"
                             % (what, multihost.rank(), self.shape,
                                self.ranks.ravel().tolist()))

    def group(self, axis):
        """The process group of this rank's line along ``axis``."""
        self._member("Mesh.group")
        if axis not in self._groups:
            raise MXNetError("mesh %s has no axis %r" % (self.shape, axis))
        return self._groups[axis]

    def axis_index(self, axis):
        self._member("Mesh.axis_index")
        return self.coordinate[axis]

    def __repr__(self):
        return "Mesh(%s, device=%s)" % (self.shape, self.device)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart):
    ``spec`` holds only axis names the mesh has."""
    mesh: Mesh
    spec: tuple


def factor_devices(n, num_axes):
    """Factor ``n`` ranks into ``num_axes`` near-balanced mesh dims,
    largest first: 8 ranks, 3 axes -> (2, 2, 2); 8, 2 -> (4, 2); 6, 2 ->
    (3, 2)."""
    dims = []
    remaining = n
    for i in range(num_axes - 1, 0, -1):
        # greedily peel the smallest factor > 1 for the innermost axes
        target = max(2, int(round(remaining ** (1.0 / (i + 1)))))
        f = 1
        for cand in range(target, 1, -1):
            if remaining % cand == 0:
                f = cand
                break
        if f == 1:
            for cand in range(target + 1, remaining + 1):
                if remaining % cand == 0:
                    f = cand
                    break
        dims.append(f)
        remaining //= f
    dims.append(remaining)
    return tuple(sorted(dims, reverse=True))


def _all_ranks():
    if not dist.is_initialized():
        raise MXNetError("a mesh lies over the ranks of the default process "
                         "group, and there is none: call "
                         "multihost.init_from_env (or run under "
                         "test_utils.run_ranks)")
    return list(range(dist.get_world_size()))


def _rank_device(device):
    """``device``, where the default (or a bare "cuda") is this rank's
    card."""
    dev = as_device(device)
    if dev.type == "cuda" and (device is None or device == "cuda"):
        return multihost.local_devices()[0]
    return dev


def make_mesh(axis_shapes, ranks=None, device=None):
    """A :class:`Mesh` from ``{axis_name: size}`` (insertion-ordered) over
    ``ranks`` (default: every rank of the default group), on ``device``
    (default: this rank's card).  ``-1`` for at most one axis means "all
    remaining ranks"; a mesh smaller than ``ranks`` takes the first ones.
    Every rank of the default group calls it."""
    if ranks is None:
        ranks = _all_ranks()
    else:
        _all_ranks()
    names = list(axis_shapes.keys())
    sizes = list(axis_shapes.values())
    n = len(ranks)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError("cannot infer -1 axis: %d ranks not divisible "
                             "by %d" % (n, known))
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError("mesh %s needs %d ranks, only %d available"
                         % (dict(zip(names, sizes)), total, n))
    return Mesh(dict(zip(names, sizes)), list(ranks)[:total],
                _rank_device(device))


def auto_mesh(axis_names=("data",), n_ranks=None, ranks=None, device=None):
    """A mesh over all (or ``n_ranks``) ranks, balanced across axes."""
    if ranks is None:
        ranks = _all_ranks()
    if n_ranks is not None:
        ranks = ranks[:n_ranks]
    dims = factor_devices(len(ranks), len(axis_names))
    return make_mesh(dict(zip(axis_names, dims)), ranks, device)


def current_mesh():
    """The innermost mesh of :func:`using_mesh` (or of a
    :func:`shard_map` call), or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def using_mesh(mesh):
    """Bind ``mesh`` for the enclosed scope: its axis names resolve in
    ``collective``."""
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    _tls.stack.append(mesh)
    try:
        yield mesh
    finally:
        _tls.stack.pop()


def multihost_mesh(axis_shapes=None, host_axis="host", ranks=None,
                   n_hosts=None, device=None):
    """A mesh whose leading ``host_axis`` is the process fleet (default:
    one entry a process, as ``jax.process_count()``), with
    ``axis_shapes`` (default ``{"data": -1}``) laid over each host's
    ranks.  ``ranks``/``n_hosts`` fake a fleet over fewer processes."""
    if ranks is None:
        ranks = _all_ranks()
    if n_hosts is None:
        n_hosts = multihost.num_processes()
    n_hosts = max(1, int(n_hosts))
    if len(ranks) % n_hosts:
        raise ValueError("multihost mesh: %d ranks not divisible by %d hosts"
                         % (len(ranks), n_hosts))
    shapes = {host_axis: n_hosts}
    for name, size in (axis_shapes or {"data": -1}).items():
        if name == host_axis:
            raise ValueError("axis %r collides with host axis" % name)
        shapes[name] = size
    return make_mesh(shapes, ranks, device)


def topology():
    """The fleet this process can build meshes over, with the JAX
    package's keys: a rank is a process and holds one device."""
    dev = multihost.local_devices()[0]
    return {"n_devices": multihost.num_processes(),
            "n_local_devices": 1,
            "n_hosts": multihost.num_processes(),
            "process_index": multihost.rank(),
            "platform": dev.type}


def _parse_mesh_shape(text):
    """``"data=-1,model=2"`` -> {"data": -1, "model": 2} (ordered)."""
    shapes = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError("MXNET_MESH_SHAPE entry %r is not name=size"
                             % part)
        name, _, size = part.partition("=")
        shapes[name.strip()] = int(size)
    if not shapes:
        raise ValueError("MXNET_MESH_SHAPE set but empty")
    return shapes


def _env_mesh_config():
    shape = os.environ.get("MXNET_MESH_SHAPE", "").strip()
    span = os.environ.get("MXNET_MESH_SPAN_HOSTS", "0").strip()
    return (_parse_mesh_shape(shape) if shape else None,
            span not in ("", "0", "false", "False"))


_ENV_SHAPE, _ENV_SPAN_HOSTS = _env_mesh_config()


def refresh_from_env():
    """Read ``MXNET_MESH_SHAPE`` / ``MXNET_MESH_SPAN_HOSTS`` again."""
    global _ENV_SHAPE, _ENV_SPAN_HOSTS
    _ENV_SHAPE, _ENV_SPAN_HOSTS = _env_mesh_config()


def mesh_from_env(ranks=None, device=None):
    """The mesh ``MXNET_MESH_SHAPE`` names (``"data=-1,model=2"``), or None
    when it is unset; ``MXNET_MESH_SPAN_HOSTS=1`` prepends the process
    fleet as a ``host`` axis (:func:`multihost_mesh`)."""
    if _ENV_SHAPE is None:
        return None
    if _ENV_SPAN_HOSTS:
        return multihost_mesh(_ENV_SHAPE, ranks=ranks, device=device)
    return make_mesh(_ENV_SHAPE, ranks, device)


def default_mesh(axis_names=("data",), device=None):
    """The innermost :func:`using_mesh`, else the ``MXNET_MESH_*``
    selection, else every rank balanced over ``axis_names``."""
    mesh = current_mesh()
    if mesh is not None:
        return mesh
    mesh = mesh_from_env(device=device)
    if mesh is not None:
        return mesh
    return auto_mesh(axis_names, device=device)


def _spec_names(spec):
    for a in spec:
        if a is not None and not isinstance(a, str):
            raise MXNetError("partition spec entries are axis names or "
                             "None, got %r" % (a,))
    return tuple(spec)


def filter_spec(spec, mesh):
    """Drop axis names the mesh does not have, so one model definition
    runs on dp-only, dp+tp or dp+tp+sp meshes."""
    spec = _spec_names(spec)
    if mesh is None:
        return spec
    return tuple(a if a in mesh.axis_names else None for a in spec)


def named_sharding(mesh, spec):
    """``NamedSharding(mesh, filter_spec(spec, mesh))``."""
    return NamedSharding(mesh, filter_spec(spec, mesh))


def replicated(mesh):
    """The fully replicated sharding on ``mesh``."""
    return NamedSharding(mesh, ())


def _sharding(sharding, spec):
    if isinstance(sharding, Mesh):
        return named_sharding(sharding, () if spec is None else spec)
    return sharding


def block_slices(shape, sharding, spec=None):
    """This rank's block of a global array of ``shape`` under
    ``sharding``, as a tuple of slices."""
    sh = _sharding(sharding, spec)
    sh.mesh._member("block_slices")
    if len(sh.spec) > len(shape):
        raise MXNetError("spec %s has more entries than shape %s"
                         % (sh.spec, tuple(shape)))
    out = []
    for dim, size in enumerate(shape):
        axis = sh.spec[dim] if dim < len(sh.spec) else None
        if axis is None:
            out.append(slice(None))
            continue
        n = sh.mesh.shape[axis]
        if size % n:
            raise MXNetError("dim %d of %s does not divide over axis %r of "
                             "size %d" % (dim, tuple(shape), axis, n))
        i, blk = sh.mesh.coordinate[axis], size // n
        out.append(slice(i * blk, (i + 1) * blk))
    return tuple(out)


def shard_put(value, sharding, spec=None):
    """This rank's block of the global ``value`` (a numpy array or a
    tensor) under ``sharding`` (or a :class:`Mesh` and ``spec``), as a
    contiguous tensor on the mesh's device."""
    sh = _sharding(sharding, spec)
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.asarray(value))
    block = value[block_slices(value.shape, sh)]
    return block.to(sh.mesh.device, copy=True).contiguous()


def shard_get(block, sharding, spec=None):
    """The global array (numpy, on every rank of the mesh) whose blocks
    the mesh's ranks hold: an all-gather over each sharded axis.  Every
    rank of the mesh calls it."""
    from . import collective
    sh = _sharding(sharding, spec)
    sh.mesh._member("shard_get")
    out = block.detach()
    with using_mesh(sh.mesh):
        for dim, axis in enumerate(sh.spec):
            if axis is not None:
                out = collective.all_gather(out, axis, axis=dim)
    if out.dtype == torch.bfloat16:
        out = out.float()
    return out.cpu().numpy()


def _check_specs(specs, mesh):
    """Raise where a spec in ``specs`` (a spec, or a tuple, list or dict
    of them) names an axis ``mesh`` lacks."""
    if isinstance(specs, dict):
        specs = list(specs.values())
    if isinstance(specs, tuple) and all(a is None or isinstance(a, str)
                                        for a in specs):
        bad = [a for a in specs if a is not None
               and a not in mesh.axis_names]
        if bad:
            raise MXNetError("shard_map: spec %s names axes %s the mesh %s "
                             "lacks" % (specs, bad, mesh.shape))
    elif isinstance(specs, (tuple, list)):
        for s in specs:
            _check_specs(s, mesh)


def shard_map(fn, mesh=None, in_specs=None, out_specs=None):
    """``fn`` over this rank's blocks, with ``mesh``'s axis names bound for
    ``collective`` (``mesh`` defaults to the innermost
    :func:`using_mesh`).  The blocks go in and come out as they are:
    ``in_specs`` and ``out_specs`` say how they lie on the mesh, and a
    spec naming an axis the mesh lacks raises."""
    if mesh is None:
        mesh = current_mesh()
        if mesh is None:
            raise ValueError("shard_map: no mesh passed and no using_mesh() "
                             "scope active")
    _check_specs(in_specs, mesh)
    _check_specs(out_specs, mesh)

    def mapped(*blocks):
        mesh._member("shard_map")
        with using_mesh(mesh):
            return fn(*blocks)
    return mapped


def jit_sharded(fn, name):
    """``fn`` as a named program of the mesh: each call counts one
    ``program_calls`` and one ``<name>_calls``.  It runs eagerly: a
    gloo collective is a host call, which a CUDA graph cannot hold."""

    def program(*args, **kwargs):
        profiler.bump("program_calls")
        profiler.bump(name + "_calls")
        return fn(*args, **kwargs)
    program.__name__ = name
    return program
