"""Elementwise scale ``o = x * alpha``: the CUDA kernel's wrapper and its
plain version.

Counterpart of the Pallas kernel ``pl_scale`` (body ``_scale_body``,
``tests/test_pallas_register.py:25-36``), the user kernel of the
registration surface (``rtc.py``).  The kernel is ``csrc/scale.cu`` (CUDA
C++ for ``sm_90a``, built by ``_build.load_library`` at its first
launch).  A CPU or ``meta`` tensor goes through :func:`scale_reference`;
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from .. import profiler
from . import _build

__all__ = ["scale", "scale_reference", "launch_count", "reset_launch_count",
           "KERNEL_SOURCE"]

KERNEL_SOURCE = "mxnet_tpu_torch/ops/csrc/scale.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

COUNTER = "scale_launches"


def launch_count():
    """Kernel launches since the last :func:`reset_launch_count` (the
    ``profiler`` counter ``COUNTER``)."""
    return profiler.counter(COUNTER)


def reset_launch_count():
    profiler.reset_counters(COUNTER)


def _kernel():
    fn = _build.load_library("scale").scale_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       p]
        fn.restype = ctypes.c_int
    return fn


def scale_reference(x, alpha):
    """Plain version: one fp32 multiply, rounded once to x's dtype."""
    return (x.float() * float(alpha)).to(x.dtype)


def scale(x, alpha):
    """``x * alpha`` in x's dtype.  On CUDA it launches the hand-written
    kernel; x must then be contiguous fp32, bf16 or fp16.  On the CPU (or
    ``meta``, for shape inference) it runs :func:`scale_reference`.

    The kernel has no backward: differentiate through a semantic gradient
    (``rtc.register(..., grad=...)``), as the JAX package does.
    """
    if x.device.type in ("cpu", "meta"):
        return scale_reference(x, alpha)
    if x.device.type != "cuda":
        raise MXNetError("scale: unsupported device %s" % x.device)
    if x.dtype not in _DTYPE_CODE:
        raise MXNetError("scale: dtype %s; the kernel takes one of fp32, "
                         "bf16, fp16" % x.dtype)
    if not x.is_contiguous():
        raise MXNetError("scale: the input must be contiguous")
    if torch.is_grad_enabled() and x.requires_grad:
        raise MXNetError("scale: the CUDA kernel has no backward; register "
                         "it with grad= or call it under torch.no_grad()")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), _DTYPE_CODE[x.dtype],
                 float(alpha), stream)
    if err != 0:
        raise MXNetError("scale: kernel launch failed with cudaError_t %d at "
                         "shape %s %s" % (err, tuple(x.shape), x.dtype))
    profiler.bump(COUNTER)
    return out
