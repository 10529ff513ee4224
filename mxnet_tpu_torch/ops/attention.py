"""Flash attention, forward and gradient: the CUDA kernels' wrappers and
their plain versions.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py::flash_attention``, a
``jax.custom_vjp``; here :class:`FlashAttention`, a
``torch.autograd.Function``.  CUDA C++ kernels for ``sm_90a`` compute it,
each built by ``_build.load_library`` at its first launch.  The forward
(:func:`design` picks one):

- ``csrc/flash_attn_fwd_sm90.cu`` ("wgmma+tma"): bf16 and fp16, on the
  tensor cores, fed by TMA;
- ``csrc/flash_attn_fwd_f32_sm90.cu`` ("wgmma+bf16x3"): fp32, on the
  tensor cores, each fp32 operand split into three bf16 parts and each
  product taken as six bf16 products.

Both take D in ``HEAD_DIMS`` (16, 32, 64, 128).  Any other D up to 128
runs at the next of those widths: the wrapper zero-pads q, k and v along
D (a copy), keeps the scale of the true D and slices the result back
(:func:`at_kernel_width`); D above 128 is refused.

The backward (:func:`flash_attention_backward`; :func:`design_backward`
picks one, by the same rule) recomputes the scores from the saved q, k and
v as the JAX package's ``_chunked_attn_grads`` does; its plain version is
:func:`chunked_attention_grads`:

- ``csrc/flash_attn_bwd_sm90.cu`` ("wgmma+tma"): bf16 and fp16, on the
  tensor cores, in two launches;
- ``csrc/flash_attn_bwd_f32_sm90.cu`` ("wgmma+bf16x3"): fp32, on the
  tensor cores through the same split, in two launches.

The kernels read q, k and v through their strides (:func:`check_layout`
says which layouts they take), so the model's einsum views need no copy.
A CPU tensor goes through the plain versions; a CUDA tensor always
launches a kernel, at every sequence length, or raises.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from ..base import MXNetError
from .. import profiler
from . import _build

__all__ = ["flash_attention", "flash_attention_reference", "FlashAttention",
           "flash_attention_backward", "chunked_attention_grads",
           "launch_count", "reset_launch_count", "backward_launch_count",
           "reset_backward_launch_count", "check_layout", "design",
           "design_backward", "KERNEL_SOURCES", "BACKWARD_SOURCES",
           "HEAD_DIMS", "kernel_width", "at_kernel_width"]

KERNEL_SOURCES = {
    "wgmma+tma": "mxnet_tpu_torch/ops/csrc/flash_attn_fwd_sm90.cu",
    "wgmma+bf16x3": "mxnet_tpu_torch/ops/csrc/flash_attn_fwd_f32_sm90.cu",
}
BACKWARD_SOURCES = {
    "wgmma+tma": "mxnet_tpu_torch/ops/csrc/flash_attn_bwd_sm90.cu",
    "wgmma+bf16x3": "mxnet_tpu_torch/ops/csrc/flash_attn_bwd_f32_sm90.cu",
}
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NEG = -1e30

FWD_COUNTER = "flash_attn_fwd_launches"
BWD_COUNTER = "flash_attn_bwd_launches"


def launch_count():
    """Forward kernel launches since the last :func:`reset_launch_count`
    (the ``profiler`` counter ``FWD_COUNTER``; replays of a captured graph
    count the launches captured in it)."""
    return profiler.counter(FWD_COUNTER)


def reset_launch_count():
    profiler.reset_counters(FWD_COUNTER)


def backward_launch_count():
    """Backward kernel launches (one per :func:`flash_attention_backward`
    call on the card) since the last :func:`reset_backward_launch_count`
    (the ``profiler`` counter ``BWD_COUNTER``)."""
    return profiler.counter(BWD_COUNTER)


def reset_backward_launch_count():
    profiler.reset_counters(BWD_COUNTER)


def design(dtype, head_dim):
    """Which kernel takes q, k, v of ``dtype`` at head dim ``head_dim``
    (any D up to 128; :func:`kernel_width` says at which width it runs):
    the tensor cores, ``"wgmma+tma"`` for bf16/fp16 and ``"wgmma+bf16x3"``
    for fp32 (three bf16 parts per value, six bf16 products per product:
    fp32's accuracy, never a single TF32 or bf16 product, whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says).  None for another
    dtype or a D the kernels do not take."""
    if not 0 < head_dim <= HEAD_DIMS[-1]:
        return None
    if dtype in (torch.bfloat16, torch.float16):
        return "wgmma+tma"
    if dtype == torch.float32:
        return "wgmma+bf16x3"
    return None


def design_backward(dtype, head_dim):
    """Which backward kernel takes q, k, v of ``dtype`` at head dim
    ``head_dim``, by the same rule as :func:`design`: ``"wgmma+tma"``
    (bf16/fp16) or ``"wgmma+bf16x3"`` (fp32)."""
    return design(dtype, head_dim)


def kernel_width(head_dim):
    """The width the kernels run head dim ``head_dim`` at: the least of
    ``HEAD_DIMS`` not below it.  Raises :class:`MXNetError` above 128."""
    for width in HEAD_DIMS:
        if head_dim <= width:
            return width
    raise MXNetError("flash_attention: head dim %d above %d, the widest the "
                     "kernels take" % (head_dim, HEAD_DIMS[-1]))


def at_kernel_width(fn, tensors, sm_scale):
    """``fn(*tensors, scale)`` run at :func:`kernel_width` of their head
    dim D (the last dimension): where that width W is above D, each tensor
    is zero-padded along D to W (a new contiguous copy), ``fn`` gets the
    padded tensors, and each tensor ``fn`` returns (one, or a tuple) is
    sliced back to D.  ``scale`` is ``sm_scale``, or 1/sqrt(D) of the true
    D.  Zero columns add nothing to q k^T, and zero columns of v give zero
    columns of the output, so the result is attention at D.  At D in
    ``HEAD_DIMS`` the tensors pass through as they are, uncopied."""
    d = tensors[0].shape[-1]
    width = kernel_width(d)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if width == d:
        return fn(*tensors, scale)
    out = fn(*(torch.nn.functional.pad(t, (0, width - d)) for t in tensors),
             scale)
    if isinstance(out, tuple):
        return tuple(o[..., :d] for o in out)
    return out[..., :d]


def _kernel(source, n_tensors):
    """The C launcher of ``source``: ``n_tensors`` pointers, then batch,
    heads, seq_len, d, the strides, dtype, causal, scale and the stream."""
    stem = os.path.splitext(os.path.basename(source))[0]
    fn = getattr(_build.load_library(stem), stem)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p] * n_tensors + [i, i, i, i, p, i, i,
                                         ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _layout_fault(t):
    """Why the kernels cannot read ``t`` through its strides, or None."""
    elem = t.element_size()
    if t.stride(-1) != 1:
        return "has last stride %d; the kernels need 1" % t.stride(-1)
    for dim in range(t.dim() - 1):
        if t.shape[dim] > 1 and (t.stride(dim) * elem) % 16:
            return ("has stride %d in dim %d, %d bytes, not a multiple of 16"
                    % (t.stride(dim), dim, t.stride(dim) * elem))
    if t.data_ptr() % 16:
        return "starts at an address not aligned to 16 bytes"
    return None


def check_layout(*tensors):
    """Raise :class:`MXNetError` unless the kernels can read each tensor
    through its strides: the last stride is 1, every other stride times the
    element size is a multiple of 16 bytes, and ``data_ptr`` is 16-byte
    aligned (what a TMA tensor map needs).  The stride of a dimension of
    size 1 is never stepped and is not checked.  Contiguous tensors and the
    views of ``einsum("bsd,dhk->bhsk")`` (strides (S*H*D, D, H*D, 1)) pass
    when D times the element size is a multiple of 16 bytes."""
    for name, t in zip("qkv", tensors):
        fault = _layout_fault(t)
        if fault is not None:
            raise MXNetError("flash_attention: %s %s" % (name, fault))


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


def _check_inputs(q, k, v, what):
    """What the CUDA wrappers take: one [B, H, S, D] shape and one dtype
    (fp32, bf16, fp16) on one CUDA device, D at most 128.  (The layout is
    checked at the kernel's width, :func:`check_layout`.)"""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise MXNetError("%s: q, k, v must share one [B, H, S, D] shape, got "
                         "%s %s %s" % (what, tuple(q.shape), tuple(k.shape),
                                       tuple(v.shape)))
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise MXNetError("%s: dtypes %s %s %s; the kernel takes one of fp32, "
                         "bf16, fp16" % (what, q.dtype, k.dtype, v.dtype))
    if not 0 < q.shape[-1] <= HEAD_DIMS[-1]:
        raise MXNetError("%s: head dim %d; the kernels take 1 to %d"
                         % (what, q.shape[-1], HEAD_DIMS[-1]))


def _strides(*tensors):
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(t.stride(i) for t in tensors for i in range(3)))


def _forward_kernel(q, k, v, causal, sm_scale):
    """Launch the forward kernel that :func:`design` names, at
    :func:`kernel_width`."""
    _check_inputs(q, k, v, "flash_attention")
    return at_kernel_width(
        lambda q, k, v, scale: _launch_forward(q, k, v, causal, scale),
        (q, k, v), sm_scale)


def _launch_forward(q, k, v, causal, scale):
    check_layout(q, k, v)
    b, h, s, d = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if b * h * s == 0:
        return out
    name = design(q.dtype, d)
    fn = _kernel(KERNEL_SOURCES[name], 4)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, s, d, _strides(q, k, v), _DTYPE_CODE[q.dtype],
                 int(bool(causal)), float(scale), stream)
    if err != 0:
        raise MXNetError("flash_attention: %s kernel failed with cudaError_t"
                         " %d at shape %s %s"
                         % (name, err, tuple(q.shape), q.dtype))
    profiler.bump(FWD_COUNTER)
    return out


def flash_attention_backward(q, k, v, do, causal=False, sm_scale=None):
    """The backward kernel that :func:`design_backward` names: dq, dk, dv
    of attention(q, k, v) under the output gradient ``do``, each a new
    contiguous [B, H, S, D] tensor in q's dtype.

    q, k and v are taken as :func:`flash_attention` takes them on the card
    (through their strides); ``do`` may have any layout and is copied to
    contiguous when the kernel cannot read it as it is.  Every kernel
    recomputes the scores in fp32 from the loaded values, as
    :func:`chunked_attention_grads` (their plain version) does, and keeps
    the row statistics (max, 1/sum and sum_j p_ij dp_ij) in fp32 scratch.
    ``"wgmma+tma"`` (``csrc/flash_attn_bwd_sm90.cu``) runs two launches,
    the statistics and dq, then dk and dv, with P and dS rounded to the
    input type where they enter the tensor cores; ``"wgmma+bf16x3"``
    (``csrc/flash_attn_bwd_f32_sm90.cu``) the same two launches in fp32,
    every operand split into three bf16 parts.  A head dim outside
    ``HEAD_DIMS`` runs at :func:`kernel_width` (q, k, v and ``do``
    zero-padded, copies; dq, dk, dv sliced back).  Two calls on the same
    inputs give the same bits.  CUDA tensors only; a kernel that fails
    raises.
    """
    if not (q.device == k.device == v.device == do.device) \
            or q.device.type != "cuda":
        raise MXNetError("flash_attention_backward: q, k, v, do must lie on "
                         "one CUDA device (%s, %s, %s, %s)"
                         % (q.device, k.device, v.device, do.device))
    _check_inputs(q, k, v, "flash_attention_backward")
    if do.shape != q.shape:
        raise MXNetError("flash_attention_backward: do has shape %s, q %s"
                         % (tuple(do.shape), tuple(q.shape)))
    do = do.to(q.dtype)
    if _layout_fault(do) is not None:
        do = do.clone(memory_format=torch.contiguous_format)
    return at_kernel_width(
        lambda q, k, v, do, scale: _launch_backward(q, k, v, do, causal,
                                                    scale),
        (q, k, v, do), sm_scale)


def _launch_backward(q, k, v, do, causal, scale):
    check_layout(q, k, v)
    b, h, s, d = q.shape
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    if b * h * s == 0:
        return dq, dk, dv
    # per (b*h, row): the softmax max, 1/sum and sum_j p_ij * dp_ij
    stats = torch.empty((3, b * h, s), dtype=torch.float32, device=q.device)
    name = design_backward(q.dtype, d)
    fn = _kernel(BACKWARD_SOURCES[name], 8)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 stats.data_ptr(), b, h, s, d, _strides(q, k, v, do),
                 _DTYPE_CODE[q.dtype], int(bool(causal)), float(scale),
                 stream)
    if err != 0:
        raise MXNetError("flash_attention_backward: %s kernel failed with "
                         "cudaError_t %d at shape %s %s"
                         % (name, err, tuple(q.shape), q.dtype))
    profiler.bump(BWD_COUNTER)
    return dq, dk, dv


def chunked_attention_grads(q, k, v, do, causal=False, sm_scale=None,
                            chunk=512):
    """Plain version of the backward: the JAX package's
    ``_chunked_attn_grads``.  In fp32 throughout, q rows in chunks of
    ``chunk`` (the q axis padded to a multiple of it, padded rows masked):
    s = q k^T * scale, masked to -1e30, p = softmax(s), dv = p^T do,
    dp = do v^T, ds = p (dp - sum(dp p)), ds zeroed where masked,
    dq = ds k * scale, dk = ds^T q * scale, dk and dv summed over the
    chunks; dq, dk, dv cast to q's, k's and v's dtypes.  The CPU path and
    the card's checks use it; a CUDA tensor never reaches it through
    :func:`flash_attention`.
    """
    b, h, s, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    c = min(chunk, s)
    n = (s + c - 1) // c if s else 0
    s_pad = n * c
    f32 = torch.float32

    def padq(x):
        x = x.to(f32)
        if s_pad != s:
            x = torch.nn.functional.pad(x, (0, 0, 0, s_pad - s))
        return x
    qs, dos = padq(q), padq(do)
    kf, vf = k.to(f32), v.to(f32)
    k_pos = torch.arange(s, device=q.device)
    dk = torch.zeros((b, h, s, d), dtype=f32, device=q.device)
    dv = torch.zeros((b, h, s, d), dtype=f32, device=q.device)
    dq = []
    for i in range(n):
        q_c, do_c = qs[:, :, i * c:(i + 1) * c], dos[:, :, i * c:(i + 1) * c]
        s_c = torch.matmul(q_c, kf.transpose(-1, -2)) * scale
        q_pos = i * c + torch.arange(c, device=q.device)
        valid = (q_pos[:, None] < s).expand(c, s)
        if causal:
            valid = valid & (q_pos[:, None] >= k_pos[None, :])
        s_c = torch.where(valid, s_c, torch.full((), _NEG, dtype=f32,
                                                 device=q.device))
        p = torch.softmax(s_c, dim=-1)
        dv = dv + torch.matmul(p.transpose(-1, -2), do_c)
        dp = torch.matmul(do_c, vf.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        ds = torch.where(valid, ds, torch.zeros((), dtype=f32,
                                                device=q.device))
        dq.append(torch.matmul(ds, kf) * scale)
        dk = dk + torch.matmul(ds.transpose(-1, -2), q_c) * scale
    dq = torch.cat(dq, dim=2)[:, :, :s] if dq else torch.zeros_like(dk)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of the JAX
    package's ``custom_vjp``: the forward runs the forward kernel on the
    card and :func:`flash_attention_reference` on the CPU, and saves q, k
    and v only; the backward recomputes, through
    :func:`flash_attention_backward` on the card and
    :func:`chunked_attention_grads` on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cuda":
            return _forward_kernel(q, k, v, causal, sm_scale)
        return flash_attention_reference(q, k, v, causal, sm_scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if q.device.type == "cuda":
            grads = flash_attention_backward(q, k, v, do, ctx.causal,
                                             ctx.sm_scale)
        else:
            grads = chunked_attention_grads(q, k, v, do, ctx.causal,
                                            ctx.sm_scale)
        return grads + (None, None)


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Flash attention: q, k, v [B, H, S, D] -> [B, H, S, D], differentiable
    in q, k and v through :class:`FlashAttention`.

    ``sm_scale`` defaults to 1/sqrt(D) and scales q before q@k^T; causal
    masking is by absolute position.  On CUDA the forward launches the
    hand-written kernel that :func:`design` names and the backward
    :func:`flash_attention_backward`; q, k, v must then share one shape
    and one dtype (fp32, bf16 or fp16), with D at most 128; at D in
    ``HEAD_DIMS`` they are read in any layout that :func:`check_layout`
    takes, and any other D is padded to :func:`kernel_width` (a copy).
    The output is a new tensor (at a padded D, a view of one).  On the CPU
    the forward runs :func:`flash_attention_reference` and the backward
    :func:`chunked_attention_grads`.
    """
    if not (q.device == k.device == v.device):
        raise MXNetError("flash_attention: q, k, v on different devices "
                         "(%s, %s, %s)" % (q.device, k.device, v.device))
    if q.device.type not in ("cpu", "cuda"):
        raise MXNetError("flash_attention: unsupported device %s" % q.device)
    return FlashAttention.apply(q, k, v, causal, sm_scale)
