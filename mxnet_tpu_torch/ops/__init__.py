"""Operators of the PyTorch package and their hand-written CUDA kernels.

``attention``: the flash-attention forward (kernel ``csrc/flash_attn_fwd.cu``),
counterpart of ``mxnet_tpu/ops/pallas_kernels.py``.
"""
from . import attention
from .attention import flash_attention, flash_attention_reference

__all__ = ["attention", "flash_attention", "flash_attention_reference"]
