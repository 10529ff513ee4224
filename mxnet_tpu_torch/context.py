"""Device contexts as ``torch.device``.

Counterpart of ``mxnet_tpu/context.py`` (``cpu()``, ``gpu()``,
``current_context()``), reduced to what the ported modules need.  The
default context is the first CUDA card.  Where there is none, resolving
the default raises :class:`MXNetError`: the package never moves work to
the CPU unless the caller asks for ``cpu()`` or ``device="cpu"``.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "current_context", "as_device"]


def cpu(device_id=0):
    return torch.device("cpu")


def gpu(device_id=0):
    """The ``device_id``-th CUDA card; raises if it is not there."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not 0 <= device_id < n:
        raise MXNetError("Invalid device id %d for gpu: %d CUDA device(s) "
                         "present (pass device='cpu' to run on the CPU)"
                         % (device_id, n))
    return torch.device("cuda", device_id)


def current_context():
    """The default device: ``gpu(0)``; raises when there is no CUDA card."""
    return gpu(0)


def as_device(device=None):
    """Resolve ``None`` (:func:`current_context`), a string or a
    ``torch.device`` to a checked ``torch.device``."""
    if device is None:
        return current_context()
    dev = torch.device(device)
    if dev.type == "cuda":
        return gpu(0 if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise MXNetError("unsupported device %r" % (device,))
    return cpu()
