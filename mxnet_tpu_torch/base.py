"""Base utilities of the PyTorch package: the framework's error type and
dtype names.

Counterpart of ``mxnet_tpu/base.py``, reduced to what the ported modules
use.  The package keeps its own copy rather than importing the JAX
package, so that it runs where JAX is not installed.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "torch_dtype", "np_dtype", "dtype_name"]


class MXNetError(Exception):
    """Error raised by the framework (parity with ``mxnet.base.MXNetError``)."""


_TORCH_TO_NP = {
    torch.float32: np.dtype(np.float32), torch.float64: np.dtype(np.float64),
    torch.float16: np.dtype(np.float16), torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64), torch.int8: np.dtype(np.int8),
    torch.uint8: np.dtype(np.uint8), torch.bool: np.dtype(np.bool_),
}
_NP_TO_TORCH = {v: k for k, v in _TORCH_TO_NP.items()}


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
