"""Multi-process runtime: ``torch.distributed`` over the launcher's env
contract.

Counterpart of ``mxnet_tpu/parallel/multihost.py:29-135``.  The JAX
package calls ``jax.distributed.initialize`` once, after which one
process sees every device; this package runs one process a rank (SPMD),
so :func:`init_from_env` joins the process to the ranks' default group
with ``torch.distributed.init_process_group``, from the same environment
names:

    MXNET_COORDINATOR   host:port of rank 0   (DMLC_PS_ROOT_URI + a port)
    MXNET_NUM_PROCESSES world size            (DMLC_NUM_WORKER)
    MXNET_PROCESS_ID    this process's rank   (DMLC_WORKER_RANK,
                                               OMPI_COMM_WORLD_RANK,
                                               PMI_RANK)

The backend is the caller's ``backend=``; by default ``nccl`` for ranks
on CUDA and ``gloo`` on ``cpu()``.  NCCL refuses two ranks on one device,
so an ``nccl`` group whose ranks on this host outnumber its cards raises
:class:`MXNetError` before NCCL is asked; ranks that share a card pass
``backend="gloo"``.  A rank's device is card ``local rank % cards``
(:func:`local_devices`).  A ``dist_*`` kvstore under a launcher is not
this module's (``kvstore.create`` keeps raising for it).
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..base import MXNetError
from ..context import as_device

__all__ = ["init_from_env", "is_initialized", "rank", "num_processes",
           "local_devices", "barrier", "host_gather_floats",
           "DEFAULT_TIMEOUT_S"]

# init_process_group's timeout, which also bounds every collective: a rank
# that never arrives fails the others after this long instead of hanging
DEFAULT_TIMEOUT_S = 600


def _env(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return v
    return default


def _local_world(world):
    """Ranks of the group on this host: ``LOCAL_WORLD_SIZE`` where a
    launcher sets it, else the whole group."""
    return int(_env("LOCAL_WORLD_SIZE", default=str(world)))


def _check_backend(backend, device, world):
    if backend == "nccl":
        if device.type != "cuda":
            raise MXNetError("init_from_env: backend 'nccl' needs ranks on "
                             "CUDA, this one is on %s" % device)
        cards = torch.cuda.device_count()
        local = _local_world(world)
        if local > cards:
            raise MXNetError(
                "init_from_env: %d ranks of an nccl group on this host "
                "would share its %d card(s); NCCL refuses two ranks on one "
                "device. Pass backend='gloo' for ranks that share a card"
                % (local, cards))
    elif backend != "gloo":
        raise MXNetError("init_from_env: unknown backend %r (nccl or gloo)"
                         % (backend,))


def init_from_env(force=False, device=None, backend=None, init_method=None,
                  timeout=None):
    """Join this process to the ranks' default group when the launcher's
    environment names more than one process (or ``force``).

    Returns ``(rank, world_size)``; ``(0, 1)`` when not launched
    distributed.  Idempotent.  ``device`` is where this rank computes
    (default: the first CUDA card); ``init_method`` overrides the
    coordinator from the environment (``run_ranks`` passes a
    ``file://`` rendezvous); ``timeout`` is in seconds
    (``DEFAULT_TIMEOUT_S``)."""
    world = int(_env("MXNET_NUM_PROCESSES", "DMLC_NUM_WORKER", default="1"))
    if world <= 1 and not force:
        return 0, 1
    if dist.is_initialized():
        return rank(), num_processes()
    proc_id = int(_env("MXNET_PROCESS_ID", "DMLC_WORKER_RANK",
                       "OMPI_COMM_WORLD_RANK", "PMI_RANK", default="0"))
    dev = as_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    _check_backend(backend, dev, world)
    if init_method is None:
        coord = _env("MXNET_COORDINATOR")
        if coord is None:
            host = _env("DMLC_PS_ROOT_URI", default="127.0.0.1")
            port = _env("MXNET_COORDINATOR_PORT", "DMLC_PS_ROOT_PORT",
                        default="49151")
            coord = "%s:%s" % (host, port)
        init_method = "tcp://" + coord
    if dev.type == "cuda":
        torch.cuda.set_device(local_devices(proc_id)[0])
    dist.init_process_group(
        backend, init_method=init_method, rank=proc_id, world_size=world,
        timeout=datetime.timedelta(seconds=timeout or DEFAULT_TIMEOUT_S))
    return proc_id, world


def is_initialized():
    return dist.is_initialized()


def rank():
    """This process's rank (ref kvstore.h:309 get_rank)."""
    return dist.get_rank() if dist.is_initialized() else 0


def num_processes():
    """World size (ref kvstore.h:316 get_group_size)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_devices(proc_id=None):
    """This rank's device, in a list: card ``local rank % cards``
    (``LOCAL_RANK`` where a launcher sets it, else the rank), or the CPU
    on a host without one."""
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    r = int(_env("LOCAL_RANK", default=str(rank() if proc_id is None
                                             else proc_id)))
    return [torch.device("cuda", r % torch.cuda.device_count())]


def barrier():
    """Block until every rank arrives (ref kvstore.h:339 Barrier)."""
    if num_processes() > 1:
        dist.barrier()


def host_gather_floats(name, value):
    """Every rank contributes one float; returns the rank-ordered list on
    all of them.  ``name`` labels the exchange (the JAX package keys its
    store by it); it goes through the default group's object gather."""
    if num_processes() == 1:
        return [float(value)]
    out = [None] * num_processes()
    dist.all_gather_object(out, (str(name), float(value)))
    if any(n != str(name) for n, _ in out):
        raise MXNetError("host_gather_floats: ranks gathered under "
                         "different names %s" % sorted({n for n, _ in out}))
    return [v for _, v in out]
