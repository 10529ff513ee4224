"""Base utilities of the PyTorch package: the framework's error type and
dtype names.

Counterpart of ``mxnet_tpu/base.py``, reduced to what the ported modules
use.  The package keeps its own copy rather than importing the JAX
package, so that it runs where JAX is not installed.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "Registry", "torch_dtype", "np_dtype",
           "dtype_name", "DTYPE_TO_CODE", "CODE_TO_DTYPE"]


class MXNetError(Exception):
    """Error raised by the framework (parity with ``mxnet.base.MXNetError``)."""


class Registry:
    """Objects by case-insensitive name, with aliases (counterpart of
    ``mxnet_tpu/base.py:93-130``; the initializers register here)."""

    def __init__(self, kind):
        self.kind = kind
        self._store = {}

    def register(self, obj, name=None, aliases=()):
        key = (name or getattr(obj, "__name__", None) or str(obj)).lower()
        self._store[key] = obj
        for a in aliases:
            self._store[a.lower()] = obj
        return obj

    def get(self, name):
        key = name.lower()
        if key not in self._store:
            raise MXNetError("Cannot find %s '%s'. Registered: %s"
                             % (self.kind, name, sorted(self._store)))
        return self._store[key]

    def find(self, name):
        return self._store.get(name.lower())

    def names(self):
        return sorted(self._store)

    def create(self, spec, *args, **kwargs):
        """An instance from a name, or ``spec`` itself."""
        if isinstance(spec, str):
            return self.get(spec)(*args, **kwargs)
        return spec


_TORCH_TO_NP = {
    torch.float32: np.dtype(np.float32), torch.float64: np.dtype(np.float64),
    torch.float16: np.dtype(np.float16), torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64), torch.int8: np.dtype(np.int8),
    torch.uint8: np.dtype(np.uint8), torch.bool: np.dtype(np.bool_),
}
_NP_TO_TORCH = {v: k for k, v in _TORCH_TO_NP.items()}

# mshadow type codes (reference mshadow/base.h TypeFlag), which the binary
# NDArray format stores (``mxnet_tpu/base.py:41-50``); bfloat16 takes the
# JAX package's code 7.
DTYPE_TO_CODE = {
    torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.uint8: 3,
    torch.int32: 4, torch.int8: 5, torch.int64: 6, torch.bfloat16: 7,
}
CODE_TO_DTYPE = {v: k for k, v in DTYPE_TO_CODE.items()}


def torch_dtype(dtype):
    """A dtype given as a ``torch.dtype``, numpy dtype, type or name
    (``"float32"``, ``"bfloat16"``) -> ``torch.dtype``."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype in ("bfloat16", "bf16"):
        return torch.bfloat16
    try:
        return _NP_TO_TORCH[np.dtype(dtype)]
    except (KeyError, TypeError) as e:
        raise MXNetError("unsupported dtype %r" % (dtype,)) from e


def np_dtype(dtype):
    """``torch.dtype`` -> numpy dtype; bfloat16, which numpy lacks, stays
    ``torch.bfloat16``."""
    return _TORCH_TO_NP.get(dtype, dtype)


def dtype_name(dtype):
    """A dtype's canonical name (``"float32"``, ``"bfloat16"``), as symbol
    attrs store it."""
    return str(torch_dtype(dtype)).replace("torch.", "")
