"""Test helpers: the synthetic-digits stand-in for MNIST, and the
fp64-referenced row check of the flash-attention backward.

``get_mnist`` is this package's own copy of the recipe in
``mxnet_tpu/test_utils.py:396-434`` (numpy only, so the arrays are equal
bit for bit): ``RandomState(42)``, 10 prototype images, 4096 train and
1024 test images of prototype plus N(0, 0.3) noise clipped to [0, 1],
labels as float32.  The real MNIST idx files are not in the repository;
reading them is not ported.

``sharp_row_check`` holds a backward kernel's dq, dk and dv to an fp64
reference (``attention_grads_fp64``), row by row, with a limit set by
the plain version's own distance from fp64 (see ``SHARP_ROW_C``).
``chip_smoke.py`` applies it to the backward's sharp cases on the card,
and ``tests/test_torch_attention_grad.py`` on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["get_mnist", "attention_grads_fp64", "row_errors",
           "sharp_row_check", "SHARP_ROW_C"]


def _synthetic_digits(n, rng, protos):
    labels = rng.randint(0, 10, n)
    images = protos[labels] + rng.normal(0, 0.3, (n, 28, 28)).astype(
        np.float32)
    return np.clip(images, 0.0, 1.0)[:, None, :, :], labels.astype(
        np.float32)


def get_mnist():
    """dict(train_data, train_label, test_data, test_label); images NCHW
    float32 in [0, 1]."""
    rng = np.random.RandomState(42)
    protos = rng.rand(10, 28, 28).astype(np.float32)
    tr_x, tr_y = _synthetic_digits(4096, rng, protos)
    te_x, te_y = _synthetic_digits(1024, rng, protos)
    return {"train_data": tr_x, "train_label": tr_y,
            "test_data": te_x, "test_label": te_y}


# Where one key takes nearly all of a query's probability (sm_scale 0.5
# spreads the scores wide), ds = p (dp - sum(p dp)) cancels and a row of
# dq or dk is small against the terms it sums.  Measured against the row's
# largest value, the plain fp32 backward then lies far from the exact
# gradient (up to 0.90 of a row at (2, 4, 200, 64) causal and 2.66 at
# D 128 on the H100), and a kernel, which sums the same terms in other
# fp32 orders, lies as far but not in the same rows: held row by row to
# c times the plain version's error, a kernel failed wherever the plain
# version happened to be lucky (7 of 20 draws in fp32 at D 128).  So each
# row's error is taken against the size of the terms the row sums
# (``attention_grads_fp64``'s scales: for dq, scale * sum_j p_ij (|dp_ij|
# + sum_l p_il |dp_il|) |k_j|, the most a rounding of p, dp or their
# products can move it; for dk the same over queries; for dv sum_i p_ij
# |do_i|), and its largest entry: the error that the arithmetic's
# roundings leave does not depend on how much the row cancels.  A
# kernel's row is held to SHARP_ROW_C times the plain version's row
# error, plus the dtype's row tolerance for the roundings the plain
# version does not make (the 16-bit P and dS of the tensor-core kernels
# read up to 0.0070 of the terms in their CPU model; the tolerance of
# bf16 is 0.0117).  SHARP_ROW_C = 2: a second fp32 summation order errs by
# an amount of the plain version's size, not the same amount.  A kernel
# that is wrong in a row (a key tile lost, a scale misapplied) errs by a
# share of the terms themselves, O(1) against 2^-8.
SHARP_ROW_C = 2.0


def attention_grads_fp64(q, k, v, do, causal, sm_scale):
    """dq, dk, dv of softmax attention in fp64, the plain backward's formula
    (scores of masked keys -1e30, ds zeroed where masked), on q's device,
    and the size of the terms each entry sums (see ``SHARP_ROW_C``):
    ((dq, dk, dv), (dq's, dk's, dv's term sizes))."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    s = q @ k.transpose(-1, -2) * sm_scale
    n = q.shape[2]
    keep = torch.ones(n, n, dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.tril(keep)
    s = s.masked_fill(~keep, -1e30)
    p = torch.softmax(s, dim=-1)
    dv = p.transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = ds.masked_fill(~keep, 0.0)
    w = p * (dp.abs() + (p * dp.abs()).sum(-1, keepdim=True))
    w = w.masked_fill(~keep, 0.0)
    grads = (ds @ k * sm_scale, ds.transpose(-1, -2) @ q * sm_scale, dv)
    scales = (w @ k.abs() * sm_scale, w.transpose(-1, -2) @ q.abs()
              * sm_scale, p.transpose(-1, -2) @ do.abs())
    return grads, scales


def row_errors(got, exact, scales, floor):
    """For each of dq, dk, dv: each row's max|got - exact| over the row's
    largest term size (``scales``, floored at ``floor``), fp64 tensors of
    the rows' shape."""
    out = []
    for g, e, t in zip(got, exact, scales):
        diff = (g.double() - e.double()).abs().amax(-1)
        out.append(diff / t.double().amax(-1).clamp_min(floor))
    return out


def sharp_row_check(got, plain, exact, scales, rtol, c=SHARP_ROW_C):
    """Hold a kernel's gradients ``got`` (dq, dk, dv) to the fp64 ones
    ``exact`` row by row (:func:`row_errors` against the term sizes
    ``scales``, floored at the smallest normal of ``got``'s dtype): each
    row's error must not exceed ``c`` times the plain version's (``plain``,
    in the kernel's dtype) plus ``rtol``.  Returns dict(kernel, plain: the
    largest row errors of each; worst: the largest ratio of a row's error
    to its limit; ok: worst <= 1)."""
    floor = torch.finfo(got[0].dtype).tiny
    kern = row_errors(got, exact, scales, floor)
    ref = row_errors(plain, exact, scales, floor)
    worst = max((k / (c * p + rtol)).max().item() for k, p in zip(kern, ref))
    return dict(kernel=max(k.max().item() for k in kern),
                plain=max(p.max().item() for p in ref), worst=worst,
                ok=worst <= 1.0)
