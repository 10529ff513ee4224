"""PyTorch/CUDA port of the MXNet-capability framework.

A second package beside ``mxnet_tpu`` (the JAX reference).  It imports
``torch`` and never ``jax`` or ``mxnet_tpu``.  Every Pallas kernel of the
JAX package becomes a kernel written by hand for Hopper (``sm_90a``),
built from the sources under ``ops/csrc`` at first use.

Ported so far: transformer-LM inference (``models.transformer``) through
the flash-attention forward kernel (``ops.attention``).
"""
from __future__ import annotations

from .base import MXNetError
from .context import cpu, gpu, current_context
from . import ops, models

__all__ = ["MXNetError", "cpu", "gpu", "current_context",
           "ops", "models"]
