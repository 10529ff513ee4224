"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py::flash_attention``.  The
kernel is ``csrc/flash_attn_fwd.cu`` (CUDA C++ for ``sm_90a``, built by
``_build.load_library`` at its first launch).  A CPU tensor goes through
:func:`flash_attention_reference`; a CUDA tensor always launches the
kernel, at every sequence length, or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["flash_attention", "flash_attention_reference", "launch_count",
           "reset_launch_count", "KERNEL_SOURCE", "HEAD_DIMS"]

KERNEL_SOURCE = "mxnet_tpu_torch/ops/csrc/flash_attn_fwd.cu"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NEG = -1e30

_launches = 0


def launch_count():
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count():
    global _launches
    _launches = 0


def _kernel():
    lib = _build.load_library("flash_attn_fwd")
    fn = lib.flash_attn_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_reference(q, k, v, causal=False, sm_scale=None):
    """Plain version: fp32 scores, -1e30 mask, softmax, P@V, cast back.

    q, k, v [B, H, S, D] -> [B, H, S, D] in q's dtype.  The CPU path and
    the tests use it; a CUDA tensor never reaches it through
    :func:`flash_attention`.
    """
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        pos_q = torch.arange(q.shape[2], device=q.device)
        pos_k = torch.arange(k.shape[2], device=q.device)
        s = s.masked_fill(pos_q[:, None] < pos_k[None, :], _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Flash attention forward: q, k, v [B, H, S, D] -> [B, H, S, D].

    ``sm_scale`` defaults to 1/sqrt(D) and scales q before q@k^T; causal
    masking is by absolute position.  On CUDA it launches the hand-written
    kernel; q, k, v must then be contiguous, of one shape and one dtype
    (fp32, bf16 or fp16), with D in ``HEAD_DIMS``.  On the CPU it runs
    :func:`flash_attention_reference`.

    Forward only: there is no ``torch.autograd.Function`` yet, because
    training is not ported yet; call it under ``torch.no_grad()`` or
    ``torch.inference_mode()`` on CUDA.
    """
    if not (q.device == k.device == v.device):
        raise MXNetError("flash_attention: q, k, v on different devices "
                         "(%s, %s, %s)" % (q.device, k.device, v.device))
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise MXNetError("flash_attention: unsupported device %s" % q.device)
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise MXNetError("flash_attention: q, k, v must share one [B, H, S, D]"
                         " shape, got %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise MXNetError("flash_attention: dtypes %s %s %s; the kernel takes "
                         "one of fp32, bf16, fp16" % (q.dtype, k.dtype, v.dtype))
    b, h, s, d = q.shape
    if d not in HEAD_DIMS:
        raise MXNetError("flash_attention: head dim %d not in %s"
                         % (d, HEAD_DIMS))
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise MXNetError("flash_attention: q, k, v must be contiguous")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise MXNetError("flash_attention: the CUDA kernel has no backward "
                         "yet; call it under torch.no_grad()")
    out = torch.empty_like(q)
    if b * h * s == 0:
        return out
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b * h, s, d, _DTYPE_CODE[q.dtype], int(bool(causal)),
                 float(scale), stream)
    if err != 0:
        raise MXNetError("flash_attention: kernel launch failed with "
                         "cudaError_t %d at shape %s %s"
                         % (err, tuple(q.shape), q.dtype))
    global _launches
    _launches += 1
    return out
