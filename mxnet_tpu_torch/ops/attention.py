"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py::flash_attention``.  Two
CUDA C++ kernels for ``sm_90a`` compute it, each built by
``_build.load_library`` at its first launch (:func:`design` picks one):

- ``csrc/flash_attn_fwd_sm90.cu`` ("wgmma+tma"): bf16 and fp16 at D in
  {64, 128}, on the tensor cores, fed by TMA;
- ``csrc/flash_attn_fwd.cu`` ("simt"): fp32 at every D, and bf16/fp16 at
  D in {16, 32}, on the CUDA cores.

Both read q, k and v through their strides (:func:`check_layout` says which
layouts they take), so the model's einsum views need no copy.  A CPU
tensor goes through :func:`flash_attention_reference`; a CUDA tensor
always launches a kernel, at every sequence length, or raises.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from ..base import MXNetError
from . import _build

__all__ = ["flash_attention", "flash_attention_reference", "launch_count",
           "reset_launch_count", "check_layout", "design", "KERNEL_SOURCES",
           "HEAD_DIMS"]

KERNEL_SOURCES = {
    "simt": "mxnet_tpu_torch/ops/csrc/flash_attn_fwd.cu",
    "wgmma+tma": "mxnet_tpu_torch/ops/csrc/flash_attn_fwd_sm90.cu",
}
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


def design(dtype, head_dim):
    """Which kernel takes q, k, v of ``dtype`` at head dim ``head_dim``:
    ``"wgmma+tma"`` (16-bit at D 64 or 128) or ``"simt"``.  fp32 stays on
    the SIMT kernel: the tensor cores take fp32 only as TF32."""
    if dtype in (torch.bfloat16, torch.float16) and head_dim in (64, 128):
        return "wgmma+tma"
    return "simt"


def _kernel(name):
    stem = os.path.splitext(os.path.basename(KERNEL_SOURCES[name]))[0]
    fn = getattr(_build.load_library(stem), stem)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def check_layout(*tensors):
    """Raise :class:`MXNetError` unless the kernels can read each tensor
    through its strides: the last stride is 1, every other stride times the
    element size is a multiple of 16 bytes, and ``data_ptr`` is 16-byte
    aligned (what a TMA tensor map needs).  The stride of a dimension of
    size 1 is never stepped and is not checked.  Contiguous tensors and the
    views of ``einsum("bsd,dhk->bhsk")`` (strides (S*H*D, D, H*D, 1)) pass
    when D times the element size is a multiple of 16 bytes."""
    for name, t in zip("qkv", tensors):
        elem = t.element_size()
        if t.stride(-1) != 1:
            raise MXNetError("flash_attention: %s has last stride %d; the "
                             "kernels need 1" % (name, t.stride(-1)))
        for dim in range(t.dim() - 1):
            if t.shape[dim] > 1 and (t.stride(dim) * elem) % 16:
                raise MXNetError(
                    "flash_attention: %s has stride %d in dim %d, %d bytes, "
                    "not a multiple of 16" % (name, t.stride(dim), dim,
                                              t.stride(dim) * elem))
        if t.data_ptr() % 16:
            raise MXNetError("flash_attention: %s starts at an address not "
                             "aligned to 16 bytes" % name)


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
    kernel that :func:`design` names; q, k, v must then share one shape and
    one dtype (fp32, bf16 or fp16), with D in ``HEAD_DIMS``, in any layout
    that :func:`check_layout` takes; the output is a new contiguous tensor.
    On the CPU it runs :func:`flash_attention_reference`.

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
    check_layout(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise MXNetError("flash_attention: the CUDA kernel has no backward "
                         "yet; call it under torch.no_grad()")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if b * h * s == 0:
        return out
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    name = design(q.dtype, d)
    fn = _kernel(name)
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                        for i in range(3)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, s, d, strides, _DTYPE_CODE[q.dtype],
                 int(bool(causal)), float(scale), stream)
    if err != 0:
        raise MXNetError("flash_attention: %s kernel failed with cudaError_t"
                         " %d at shape %s %s"
                         % (name, err, tuple(q.shape), q.dtype))
    global _launches
    _launches += 1
    return out
