"""Operators of the PyTorch package and their hand-written CUDA kernels.

Registered ops (``registry.OP_REGISTRY``, behind ``nd.<op>`` and
``sym.<op>``, the ``_contrib_*`` ones also under ``nd.contrib`` and
``sym.contrib``): ``elemwise``, ``reduce``, ``matrix``, ``nn``,
``random_ops``, ``optim_ops``, ``ssd``, ``rcnn``, ``contrib`` and
``custom``, counterparts of the ``mxnet_tpu/ops`` modules of the same
names.  The JAX package computes them with ``jnp``/``lax`` outside any
Pallas kernel, and here they are PyTorch ops, but for greedy NMS (the
``lax.fori_loop`` under ``MultiBoxDetection`` and ``Proposal``), which is
a hand-written kernel.

Kernels, each with its plain version and launch counter:
``attention`` (on the tensor cores: the forward in
``csrc/flash_attn_fwd_sm90.cu`` and ``csrc/flash_attn_fwd_f32_sm90.cu``,
the backward in ``csrc/flash_attn_bwd_sm90.cu`` and
``csrc/flash_attn_bwd_f32_sm90.cu``, counterparts of
``mxnet_tpu/ops/pallas_kernels.py::flash_attention`` and its
``custom_vjp``) and ``scale``
(``csrc/scale.cu``, counterpart of the user kernel ``pl_scale`` that
``rtc.register`` installs) and ``nms`` (``csrc/nms.cu``, greedy
non-maximum suppression; it replaces no Pallas kernel).
"""
from . import registry, elemwise, reduce, matrix, nn, random_ops  # noqa: F401
from . import optim_ops, ssd, rcnn, contrib, custom  # noqa: F401
from . import attention, scale, nms
from .attention import flash_attention, flash_attention_reference

__all__ = ["registry", "attention", "scale", "nms", "flash_attention",
           "flash_attention_reference"]
