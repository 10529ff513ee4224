"""Base utilities of the PyTorch package: the framework's error type.

Counterpart of ``mxnet_tpu/base.py``, reduced to what the ported modules
use.  The package keeps its own copy rather than importing the JAX
package, so that it runs where JAX is not installed.
"""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(Exception):
    """Error raised by the framework (parity with ``mxnet.base.MXNetError``)."""
