"""Device contexts over ``torch.device``.

Counterpart of ``mxnet_tpu/context.py`` (``Context``, ``cpu()``, ``gpu()``,
``cpu_pinned()`` :111, ``current_context()``, ``num_gpus()``).  A
:class:`Context` names a device and resolves to a ``torch.device``
(``torch_device``); every ``cpu(i)`` is the one host device, and so is
``cpu_pinned(i)``: on a host with a card, the arrays made on it are
page-locked (:meth:`Context.place`), so their copies to the card can be
asynchronous; without one they are plain host memory, as the JAX
package's ``cpu_pinned`` is its CPU device.  ``with ctx:`` makes it the
default for the block, as MXNet tests scope their devices.  Outside such
a block the default is the first CUDA card.  Where there is none,
resolving the default raises :class:`MXNetError`: the package never
moves work to the CPU unless the caller asks for ``cpu()`` or
``device="cpu"``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "num_gpus",
           "current_context", "as_context", "as_device"]


def _check_gpu(device_id):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not 0 <= device_id < n:
        raise MXNetError("Invalid device id %d for gpu: %d CUDA device(s) "
                         "present (pass device='cpu' to run on the CPU)"
                         % (device_id, n))


class Context:
    """A device context: ``Context("cpu")``, ``Context("cpu_pinned")`` or
    ``Context("gpu", i)``.  Equality and hashing by (device_type,
    device_id), as in MXNet."""

    _default = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in ("cpu", "cpu_pinned", "gpu"):
            raise MXNetError("unknown device type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)
        self._old = []

    @property
    def torch_device(self):
        """The ``torch.device``; a gpu context checks that its card is
        there."""
        if self.device_type != "gpu":
            return torch.device("cpu")
        _check_gpu(self.device_id)
        return torch.device("cuda", self.device_id)

    def place(self, tensor):
        """``tensor`` as this context keeps it: page-locked for
        ``cpu_pinned`` on a host with a card, else as it is."""
        if self.device_type == "cpu_pinned" and torch.cuda.is_available() \
                and not tensor.is_pinned():
            return tensor.pin_memory()
        return tensor

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old.append(getattr(Context._default, "value", None))
        Context._default.value = self
        return self

    def __exit__(self, *exc):
        Context._default.value = self._old.pop()


def cpu(device_id=0):
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    """Host memory that copies to the card asynchronously (page-locked
    where there is a card)."""
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    """The ``device_id``-th CUDA card; raises if it is not there."""
    _check_gpu(device_id)
    return Context("gpu", device_id)


def num_gpus():
    """The number of CUDA cards (``mxnet_tpu/context.py:131``); 0 without
    CUDA.  Never raises."""
    try:
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    except RuntimeError:
        return 0


def current_context():
    """The context of the innermost ``with ctx:`` block, else ``gpu(0)``;
    raises when that is the default and there is no CUDA card."""
    ctx = getattr(Context._default, "value", None)
    return ctx if ctx is not None else gpu(0)


def as_context(device=None):
    """Resolve ``None`` (:func:`current_context`), a :class:`Context`, a
    string or a ``torch.device`` to a checked :class:`Context`."""
    if device is None:
        return current_context()
    if isinstance(device, Context):
        device.torch_device  # noqa: B018 - raises for a missing card
        return device
    try:
        dev = torch.device(device)
    except (RuntimeError, TypeError) as e:
        raise MXNetError("unsupported device %r" % (device,)) from e
    if dev.type == "cuda":
        return gpu(0 if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise MXNetError("unsupported device %r" % (device,))
    return cpu()


def as_device(device=None):
    """Like :func:`as_context`, as a ``torch.device``."""
    return as_context(device).torch_device
