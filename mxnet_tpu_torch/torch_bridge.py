"""The tensor bridge: ``to_torch``, ``from_torch`` and ``pytorch_fn``.

Counterpart of ``mxnet_tpu/torch.py``, reached as ``mxnet_tpu_torch.torch``
as there.  There the bridge copies between JAX arrays and torch tensors
through the host; here an NDArray holds a torch tensor already, so the
bridge copies on the array's device.  The file is not called
``torch.py``, so that no module of this package can be taken for
PyTorch; the package binds it to the name ``torch`` last.
"""
from __future__ import annotations

import torch

from . import ndarray as nd
from .context import as_context

__all__ = ["to_torch", "from_torch", "pytorch_fn"]


def to_torch(arr):
    """NDArray -> a torch.Tensor copy on the array's device, outside
    autograd."""
    return arr._data.detach().clone()


def from_torch(tensor, ctx=None):
    """torch.Tensor -> an NDArray copy on ``ctx`` (default: the tensor's
    own device)."""
    ctx = as_context(tensor.device if ctx is None else ctx)
    return nd.NDArray(tensor.detach().to(ctx.torch_device, copy=True), ctx)


def pytorch_fn(fn):
    """Wrap a torch callable so that it takes and returns NDArrays.

    >>> relu = pytorch_fn(torch.nn.functional.relu)
    >>> y = relu(x_ndarray)
    """
    def wrapped(*args, **kwargs):
        conv = [to_torch(a) if isinstance(a, nd.NDArray) else a
                for a in args]
        out = fn(*conv, **kwargs)
        if isinstance(out, (list, tuple)):
            return [from_torch(o) if torch.is_tensor(o) else o for o in out]
        return from_torch(out) if torch.is_tensor(out) else out
    wrapped.__name__ = getattr(fn, "__name__", "pytorch_fn")
    return wrapped
