"""Operators of the PyTorch package and their hand-written CUDA kernels.

Registered ops (``registry.OP_REGISTRY``, behind ``nd.<op>`` and
``sym.<op>``): ``elemwise``, ``reduce``, ``matrix``, ``nn``,
``random_ops`` and ``optim_ops``, counterparts of the ``mxnet_tpu/ops``
modules of the same names.  None of them is a hand-written kernel: the
JAX package computes them with ``jnp``/``lax`` outside any Pallas
kernel, and here they are PyTorch ops.

Kernels, each with its plain version and launch counter:
``attention`` (on the tensor cores: the forward in
``csrc/flash_attn_fwd_sm90.cu`` and ``csrc/flash_attn_fwd_f32_sm90.cu``,
the backward in ``csrc/flash_attn_bwd_sm90.cu`` and
``csrc/flash_attn_bwd_f32_sm90.cu``, counterparts of
``mxnet_tpu/ops/pallas_kernels.py::flash_attention`` and its
``custom_vjp``) and ``scale``
(``csrc/scale.cu``, counterpart of the user kernel ``pl_scale`` that
``rtc.register`` installs).
"""
from . import registry, elemwise, reduce, matrix, nn, random_ops  # noqa: F401
from . import optim_ops  # noqa: F401
from . import attention, scale
from .attention import flash_attention, flash_attention_reference

__all__ = ["registry", "attention", "scale", "flash_attention",
           "flash_attention_reference"]
