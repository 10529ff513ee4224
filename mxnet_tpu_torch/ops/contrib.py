"""contrib ops: CTC loss, quantization, FFT and count sketch.

Counterpart of ``mxnet_tpu/ops/contrib.py``: ``_contrib_CTCLoss``:60
(aliases ``CTCLoss`` and ``ctc_loss``), ``_contrib_quantize``:108,
``_contrib_dequantize``:121, ``_contrib_fft``:134, ``_contrib_ifft``:143
and ``_contrib_count_sketch``:152.  None is a kernel: the JAX package
writes them in ``jnp``/``lax`` outside any Pallas kernel.

- CTC is the JAX package's forward-alpha recursion (``_ctc_single``:24)
  over the batch, one step a time step, in float32 log space with its
  ``-1e30`` for an impossible state, so an infeasible alignment gives the
  JAX package's loss (about 1e30) and not infinity.  Labels follow its
  conventions: with ``blank_label="first"`` the blank is 0, real labels
  are 1..C-1 and 0 pads; with ``"last"`` the blank is C-1 and -1 pads;
  ``label_lengths``/``data_lengths`` (with ``use_*_lengths``) override
  the padding and the time length.  The second output (zeros like the
  data) is hidden, as there.  The gradient is autograd's through the
  recursion.
- fft/ifft keep MXNet's interleaved (real, imaginary) last axis; ifft is
  not normalised (it multiplies by n), as in the reference.
- quantize rounds half to even (``jnp.round``, ``torch.round``).
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register

NEG_INF = -1e30


def _logsumexp3(a, b, c):
    return torch.logsumexp(torch.stack([a, b, c]), dim=0)


@register("_contrib_CTCLoss", aliases=["ctc_loss", "CTCLoss"],
          num_outputs=2, num_visible_outputs=1, nondiff_inputs=(1, 2, 3))
def _ctc_loss(data, label, *opt, use_data_lengths=False,
              use_label_lengths=False, blank_label="first", **kw):
    """data (T, N, C) activations; label (N, L) padded labels -> (N,)."""
    opt = list(opt)
    data_lengths = opt.pop(0) if use_data_lengths else None
    label_lengths = opt.pop(0) if use_label_lengths else None
    t_max, batch, c = data.shape
    n_lab = label.shape[1]
    dev = data.device
    logp = torch.log_softmax(data.to(torch.float32), dim=-1)
    lab = label.to(torch.int64)
    if blank_label == "first":
        blank, pad = 0, 0
    else:
        blank, pad = c - 1, -1
    lab_len = (label_lengths.to(torch.int64) if label_lengths is not None
               else (lab != pad).sum(dim=1))
    d_len = (data_lengths.to(torch.int64) if data_lengths is not None
             else torch.full((batch,), t_max, dtype=torch.int64, device=dev))
    s = 2 * n_lab + 1
    sidx = torch.arange(s, device=dev)
    lab_pos = torch.div(sidx - 1, 2, rounding_mode="floor").clamp(0, n_lab - 1)
    ext = torch.where(sidx % 2 == 1, lab[:, lab_pos],
                      torch.full((batch, s), blank, dtype=torch.int64,
                                 device=dev))                       # (N, S)
    s_len = 2 * lab_len + 1
    ext_valid = sidx[None, :] < s_len[:, None]
    prev2 = torch.where(sidx >= 2, ext[:, (sidx - 2).clamp(min=0)],
                        torch.full_like(ext, -1))
    can_skip = (sidx % 2 == 1) & (ext != prev2) & (sidx >= 2)
    ext_at = ext % c  # a -1 pad reads the last class, as jnp indexing does
    neg = torch.full((batch, s), NEG_INF, dtype=torch.float32, device=dev)
    first = logp[0].gather(1, ext_at)                                   # (N, S)
    alpha = torch.where((sidx == 0) | ((sidx == 1) & (s_len[:, None] > 1)),
                        first, neg)
    pad1 = neg[:, :1]
    pad2 = neg[:, :2]
    for t in range(1, t_max):
        a_prev1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a_prev2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], dim=1),
                              neg)
        new = _logsumexp3(alpha, a_prev1, a_prev2) + logp[t].gather(1, ext_at)
        new = torch.where(ext_valid, new, neg)
        alpha = torch.where((t < d_len)[:, None], new, alpha)
    last = alpha.gather(1, (s_len - 1).clamp(min=0)[:, None])[:, 0]
    last2 = torch.where(s_len >= 2,
                        alpha.gather(1, (s_len - 2).clamp(min=0)[:, None])[:, 0],
                        neg[:, 0])
    loss = -torch.logsumexp(torch.stack([last, last2]), dim=0)
    return loss.to(data.dtype), torch.zeros_like(data)


def _q_range(dtype):
    return (0.0, 255.0) if dtype == torch.uint8 else (-127.0, 127.0)


@register("_contrib_quantize", num_outputs=3, nondiff_inputs=(0, 1, 2))
def _quantize(data, min_range, max_range, out_type="uint8", **kw):
    qdt = torch.uint8 if out_type == "uint8" else torch.int8
    qmin, qmax = _q_range(qdt)
    mn, mx = min_range.reshape(()), max_range.reshape(())
    scale = (qmax - qmin) / (mx - mn)
    q = torch.clamp(torch.round((data - mn) * scale + qmin), qmin, qmax)
    return q.to(qdt), mn.reshape((1,)), mx.reshape((1,))


@register("_contrib_dequantize", nondiff_inputs=(0, 1, 2))
def _dequantize(data, min_range, max_range, out_type="float32", **kw):
    qmin, qmax = _q_range(data.dtype)
    mn, mx = min_range.reshape(()), max_range.reshape(())
    scale = (mx - mn) / (qmax - qmin)
    return ((data.to(torch.float32) - qmin) * scale + mn).to(
        torch_dtype(out_type))


@register("_contrib_fft")
def _fft(data, compute_size=128, **kw):
    """The FFT of the last axis, (real, imaginary) interleaved."""
    out = torch.view_as_real(torch.fft.fft(data.to(torch.complex64), dim=-1))
    return out.reshape(data.shape[:-1] + (data.shape[-1] * 2,)).to(
        torch.float32)


@register("_contrib_ifft")
def _ifft(data, compute_size=128, **kw):
    """The unnormalised inverse FFT of interleaved pairs: its real part."""
    n = data.shape[-1] // 2
    comp = torch.view_as_complex(
        data.to(torch.float32).reshape(data.shape[:-1] + (n, 2)).contiguous())
    return (torch.fft.ifft(comp, dim=-1) * n).real.to(torch.float32)


@register("_contrib_count_sketch", nondiff_inputs=(1, 2))
def _count_sketch(data, h, s, out_dim=0, processing_batch_size=32, **kw):
    """out[:, h[j]] += s[j] * data[:, j]."""
    d = data.shape[1]
    hh = h.reshape(-1).to(torch.int64)[:d]
    signed = data * s.reshape(-1)[:d][None, :]
    out = torch.zeros((data.shape[0], int(out_dim)), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, hh, signed)
