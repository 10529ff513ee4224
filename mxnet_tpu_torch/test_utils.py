"""Test helpers: the synthetic-digits stand-in for MNIST, the
fp64-referenced row check of the flash-attention backward, and the op
sweep's cases (``op_cases``, ``random_cases``), and ``set_dropout``,
which turns a zoo model's Dropout off for a parity check; ``nms_tiled``,
the greedy-NMS kernels' decomposition in plain PyTorch, and
``nms_class_buckets``, their class buckets; ``rand_ndarray`` and
``rand_sparse_ndarray`` (``mxnet_tpu/test_utils.py:122-163``, the same
draws from ``random.host_rng()``), and the sparse examples' LibSVM
writers, ``synthetic_libsvm`` and ``synthetic_fm_libsvm``.

``run_ranks`` and ``RankPool`` run a function on several ranks of one
``torch.distributed`` group: spawned processes (``torch.multiprocessing``,
the ``spawn`` method), one torch thread each, joined through a
``FileStore`` under a temporary directory (no TCP port, so several test
workers can run pools at once).  A pool starts once and runs many
functions; each call returns every rank's result, or raises with the
traceback of the rank that failed, and past its ``timeout`` (or when a
rank dies) terminates every rank.  The function travels by its import
path, so it lives in a module the ranks can import.

``get_mnist`` is this package's own copy of ``mxnet_tpu/test_utils.py:
411-449`` (numpy only, so the arrays are equal bit for bit): MNIST's
four idx files under ``path`` where they all are, else the synthetic
digits: ``RandomState(42)``, 10 prototype images, 4096 train and 1024
test images of prototype plus N(0, 0.3) noise clipped to [0, 1], labels
as float32 (``_synthetic_digits`` draws any number of them, the
``MNISTIter`` files of ``chip_smoke.py`` among them);
``get_mnist_iterator`` serves them as two ``NDArrayIter``s.

``sharp_row_check`` holds a backward kernel's dq, dk and dv to an fp64
reference (``attention_grads_fp64``), row by row, with a limit set by
the plain version's own distance from fp64 (see ``SHARP_ROW_C``).
``chip_smoke.py`` applies it to the backward's sharp cases on the card,
and ``tests/test_torch_attention_grad.py`` on the CPU.
"""
from __future__ import annotations

import os
import queue
import shutil
import tempfile
import threading
import time
import traceback

import numpy as np
import torch

from .base import MXNetError
from .ops.nn import rnn_param_size

__all__ = ["get_mnist", "get_mnist_iterator", "MNIST_FILES",
           "attention_grads_fp64", "row_errors",
           "sharp_row_check", "SHARP_ROW_C", "op_cases", "run_op_case",
           "random_cases", "moment_errors", "FP32_TOL", "BF16_TOL",
           "LIBM_TOL", "SUM_TOL", "LINALG_TOL", "canonical_signs",
           "set_dropout", "nms_tiled", "nms_class_buckets",
           "CORRUPT_PAYLOAD", "loader_batches", "rand_ndarray",
           "rand_sparse_ndarray", "synthetic_libsvm", "synthetic_fm_libsvm",
           "RankPool", "run_ranks"]


def _synthetic_digits(n, rng, protos):
    labels = rng.randint(0, 10, n)
    images = protos[labels] + rng.normal(0, 0.3, (n, 28, 28)).astype(
        np.float32)
    return np.clip(images, 0.0, 1.0)[:, None, :, :], labels.astype(
        np.float32)


MNIST_FILES = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
               "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")


def get_mnist(path="data"):
    """dict(train_data, train_label, test_data, test_label); images NCHW
    float32 in [0, 1]: the idx files under ``path`` if all four are
    there, else the synthetic digits."""
    import os
    files = [os.path.join(path, n) for n in MNIST_FILES]
    if all(os.path.exists(f) for f in files):
        from .io import _read_idx_file
        tr_x, tr_y, te_x, te_y = (_read_idx_file(f) for f in files)
        return {"train_data": tr_x.astype(np.float32)[:, None] / 255.0,
                "train_label": tr_y.astype(np.float32),
                "test_data": te_x.astype(np.float32)[:, None] / 255.0,
                "test_label": te_y.astype(np.float32)}
    rng = np.random.RandomState(42)
    protos = rng.rand(10, 28, 28).astype(np.float32)
    tr_x, tr_y = _synthetic_digits(4096, rng, protos)
    te_x, te_y = _synthetic_digits(1024, rng, protos)
    return {"train_data": tr_x, "train_label": tr_y,
            "test_data": te_x, "test_label": te_y}


def get_mnist_iterator(batch_size, flat=False, path="data"):
    """(train, val) ``NDArrayIter``s over :func:`get_mnist`'s arrays, the
    training one shuffled."""
    from .io import NDArrayIter
    blob = get_mnist(path)
    tr_x, te_x = blob["train_data"], blob["test_data"]
    if flat:
        tr_x = tr_x.reshape(tr_x.shape[0], -1)
        te_x = te_x.reshape(te_x.shape[0], -1)
    train = NDArrayIter(tr_x, blob["train_label"], batch_size, shuffle=True)
    val = NDArrayIter(te_x, blob["test_label"], batch_size)
    return train, val


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


# --- the op sweep ------------------------------------------------------------
# One or more seeded cases for every op of the elemwise, reduce, matrix, nn,
# ssd, rcnn and contrib modules: the same inputs go through two runs (the JAX package and this
# one on the CPU in tests/test_torch_ops_breadth.py; this package on the
# card and on the CPU in chip_smoke.py's op sweep), forward and, for the
# inputs in "diff", the gradient under a seeded head gradient.  Each case
# states its tolerance beside it: FP32_TOL by default; where a case needs
# more, the reason is given there.  "bf16" marks the cases that run again
# in bfloat16 (the unary and reduce ops, dot and batch_dot), held to
# BF16_TOL.  Random draws are held by their moments instead
# (``random_cases``).

FP32_TOL = dict(rtol=1e-5, atol=1e-6)
# bfloat16 keeps 8 significant bits: two runs that round the same fp32
# value at different places (a fused chain against op by op) differ by up
# to two units in the last place, 2^-6 relative
BF16_TOL = dict(rtol=2.0 ** -6, atol=2.0 ** -8)
# transcendental functions of another library's making (lgamma, erfinv,
# the inverse hyperbolics) agree to a few fp32 ulps, not one
LIBM_TOL = dict(rtol=1e-4, atol=1e-6)
# a gradient that sums tens of terms of size 1 with cancellation (a
# normalization's gamma and input gradients) lands 1e-6 from the other
# summation order's
SUM_TOL = dict(rtol=1e-5, atol=1e-5)

_UNARY_DOMAINS = {
    "abs": (0.2, 2.0, True), "arccos": (-0.9, 0.9, False),
    "arccosh": (1.1, 3.0, False), "arcsin": (-0.9, 0.9, False),
    "arcsinh": (-2.0, 2.0, False), "arctan": (-2.0, 2.0, False),
    "arctanh": (-0.9, 0.9, False), "cbrt": (0.2, 3.0, True),
    "ceil": (-3.0, 3.0, False), "cos": (-3.0, 3.0, False),
    "cosh": (-2.0, 2.0, False), "degrees": (-3.0, 3.0, False),
    "exp": (-2.0, 2.0, False), "expm1": (-2.0, 2.0, False),
    "fix": (-3.0, 3.0, False), "floor": (-3.0, 3.0, False),
    "gamma": (0.5, 4.0, False), "gammaln": (0.5, 4.0, False),
    "log": (0.1, 4.0, False), "log10": (0.1, 4.0, False),
    "log1p": (-0.5, 3.0, False), "log2": (0.1, 4.0, False),
    "negative": (-2.0, 2.0, False), "radians": (-90.0, 90.0, False),
    "rcbrt": (0.2, 3.0, True), "reciprocal": (0.5, 3.0, True),
    "relu": (-2.0, 2.0, False), "rint": (-3.0, 3.0, False),
    "round": (-3.0, 3.0, False), "rsqrt": (0.5, 4.0, False),
    "sigmoid": (-4.0, 4.0, False), "sign": (-3.0, 3.0, False),
    "sin": (-3.0, 3.0, False), "sinh": (-2.0, 2.0, False),
    "sqrt": (0.1, 4.0, False), "square": (-2.0, 2.0, False),
    "tan": (-1.2, 1.2, False), "tanh": (-2.0, 2.0, False),
    "trunc": (-3.0, 3.0, False), "erf": (-2.0, 2.0, False),
    "erfinv": (-0.9, 0.9, False), "softsign": (-3.0, 3.0, False),
}
_LIBM = ("gamma", "gammaln", "erfinv", "arccosh", "arcsinh", "arctanh",
         "cbrt", "rcbrt", "tan", "sinh", "cosh", "expm1", "log1p")


def _case(op, inputs, attrs=None, diff=(), tol=None, bf16=False, train=True,
          tag="", seeded=None, canon=None):
    return dict(op=op, inputs=[np.asarray(a, np.float32) for a in inputs],
                attrs=dict(attrs or {}), diff=tuple(diff), seeded=seeded,
                tol=dict(tol or FP32_TOL), bf16=bf16, train=train,
                canon=canon, name=op + (("[%s]" % tag) if tag else ""))


def op_cases(seed=0):
    """The sweep's cases (see above), each a dict with ``op``, ``inputs``
    (float32 numpy arrays), ``attrs``, ``diff`` (input positions whose
    gradient is compared), ``seeded`` (the outputs given a head gradient,
    None: all), ``tol``, ``bf16``, ``train``, ``canon`` (outputs unique
    only up to sign: how ``run_op_case`` makes them canonical) and
    ``name``."""
    rng = np.random.RandomState(seed)

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def signed(lo, hi, *shape):
        return u(lo, hi, *shape) * rng.choice([-1.0, 1.0], shape)

    def idx(n, *shape):
        return rng.randint(0, n, shape).astype(np.float32)

    cases = []
    add = cases.append
    # unary math
    for op, (lo, hi, sym) in _UNARY_DOMAINS.items():
        x = signed(lo, hi, 3, 5) if sym else u(lo, hi, 3, 5)
        add(_case(op, [x], diff=[0], bf16=True,
                  tol=LIBM_TOL if op in _LIBM else FP32_TOL))
    halves = np.array([[-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, -3.5]])
    add(_case("round", [halves], tag="halves to even"))
    add(_case("rint", [halves], tag="halves to even"))
    add(_case("gamma", [np.array([[-2.5, -1.5, -0.5, 0.5, 2.5]])],
              tol=LIBM_TOL, tag="negative: |gamma|"))
    add(_case("erfinv", [np.array([[-1.5, -1.0, 1.0, 1.5, 0.0]])],
              tag="edges"))
    x = u(-2, 2, 3, 5)
    for op in ("_copy", "BlockGrad", "make_loss", "_NoGradient",
               "_CrossDeviceCopy"):
        add(_case(op, [x], diff=[0]))
    add(_case("make_loss", [x], {"grad_scale": 0.5}, diff=[0],
              tag="grad_scale"))
    add(_case("smooth_l1", [u(-3, 3, 4, 5)], {"scalar": 1.5}, diff=[0]))
    for op in ("softmax", "log_softmax", "softmin"):
        add(_case(op, [u(-2, 2, 3, 4, 5)], {"axis": 1}, diff=[0]))
    add(_case("softmax", [u(-2, 2, 3, 5)], {"temperature": 2.0}, diff=[0],
              tag="temperature"))
    add(_case("Cast", [u(-2, 2, 3, 4)], {"dtype": "float64"}, diff=[0]))
    add(_case("clip", [u(-3, 3, 4, 5)], {"a_min": -1.0, "a_max": 1.5},
              diff=[0]))
    add(_case("clip", [np.array([[-1.0, 0.0, 1.0, 2.0]])],
              {"a_min": -1.0, "a_max": 1.0}, diff=[0], tag="at the bounds"))
    add(_case("where", [idx(2, 3, 4), u(-1, 1, 3, 4), u(-1, 1, 3, 4)],
              diff=[1, 2]))
    add(_case("add_n", [u(-1, 1, 3, 4) for _ in range(3)], {"num_args": 3},
              diff=[0, 1, 2]))
    add(_case("_identity_with_attr_like_rhs", [u(-1, 1, 3), u(-1, 1, 3)],
              diff=[0]))
    # binary, broadcast and scalar families
    a, b = u(0.5, 2, 2, 1, 4), u(0.5, 2, 1, 3, 4)
    for op in ("add", "sub", "mul", "div", "mod", "power", "maximum",
               "minimum", "hypot"):
        add(_case("broadcast_%s" % op, [a, b], diff=[0, 1]))
        add(_case("elemwise_%s" % op, [a[:, :1], b[:1, :1]], diff=[0, 1]))
    add(_case("_grad_add", [a, a], diff=[0, 1]))
    add(_case("_scatter_elemwise_div", [a, a + 1], diff=[0, 1]))
    bits_a, bits_b = idx(2, 3, 4), idx(2, 3, 4)
    for op in ("equal", "not_equal", "greater", "greater_equal", "lesser",
               "lesser_equal", "logical_and", "logical_or", "logical_xor"):
        add(_case("_%s" % op, [bits_a, bits_b]))
        add(_case("broadcast_%s" % op, [bits_a, bits_b[:1]]))
    x = np.round(u(-2, 2, 3, 4) * 2) / 2  # ties with the scalar 0.5
    for op in ("_plus_scalar", "_minus_scalar", "_rminus_scalar",
               "_mul_scalar", "_div_scalar", "_rdiv_scalar", "_mod_scalar",
               "_power_scalar", "_maximum_scalar", "_minimum_scalar",
               "_hypot_scalar", "_equal_scalar", "_not_equal_scalar",
               "_greater_scalar", "_greater_equal_scalar", "_lesser_scalar",
               "_lesser_equal_scalar", "_logical_and_scalar",
               "_logical_or_scalar", "_logical_xor_scalar",
               "_scatter_plus_scalar", "_scatter_minus_scalar"):
        pos = op in ("_rdiv_scalar", "_power_scalar", "_mod_scalar")
        logical = "equal" in op or "greater" in op or "lesser" in op \
            or "logical" in op
        add(_case(op, [u(0.5, 2, 3, 4) if pos else x], {"scalar": 0.5},
                  diff=[] if logical else [0]))
    add(_case("_rmod_scalar", [u(0.5, 2, 3, 4)], {"scalar": 3.0}, diff=[0]))
    add(_case("_rpower_scalar", [u(-1, 1, 3, 4)], {"scalar": 2.0},
              diff=[0]))
    # reductions (ties: two equal maxima share max's gradient)
    x = u(-2, 2, 3, 4, 5)
    x[0, 0, :2] = 3.0
    for op in ("sum", "mean", "max", "min", "nansum"):
        add(_case(op, [x], {"axis": 1}, diff=[0], bf16=True))
        add(_case(op, [x], {"axis": (0, 2), "keepdims": True}, diff=[0],
                  bf16=True, tag="axes keepdims"))
        add(_case(op, [x], diff=[0], tag="all"))
        add(_case(op, [x], {"axis": -1, "exclude": True}, diff=[0],
                  tag="exclude"))
    xp = u(0.5, 1.5, 3, 4, 5)
    for op in ("prod", "nanprod"):
        add(_case(op, [xp], {"axis": (1, 2)}, diff=[0], bf16=True))
        add(_case(op, [xp], {"axis": -1}, diff=[0], tag="last"))
    xn = u(-2, 2, 3, 4)
    xn[1, 2] = np.nan
    add(_case("nansum", [xn], {"axis": 1}, tag="nan"))
    add(_case("nanprod", [np.where(np.isnan(xn), xn, xn / 2 + 1)],
              {"axis": 1}, tag="nan"))
    for op in ("argmax", "argmin"):
        add(_case(op, [x], {"axis": 1}, bf16=True))
        add(_case(op, [x], {"axis": 2, "keepdims": True}, tag="keepdims"))
        add(_case(op, [x], tag="flat"))
    add(_case("argmax_channel", [x]))
    add(_case("norm", [x], diff=[0], bf16=True))
    add(_case("norm", [x], {"ord": 1, "axis": 1}, diff=[0], tag="l1"))
    add(_case("norm", [x], {"axis": (1, 2), "keepdims": True}, diff=[0],
              tag="axes"))
    add(_case("_square_sum", [x], {"axis": 1}, diff=[0], bf16=True))
    y = u(-1, 1, 3, 1, 5)
    add(_case("broadcast_axis", [y], {"axis": 1, "size": 4}, diff=[0]))
    add(_case("broadcast_to", [y], {"shape": (0, 4, 5)}, diff=[0]))
    add(_case("broadcast_like", [y, x], diff=[0]))
    # shape and layout
    x = u(-1, 1, 2, 3, 4)
    add(_case("Reshape", [x], {"shape": (-1, 0)}, diff=[0]))
    add(_case("Flatten", [x], diff=[0]))
    add(_case("expand_dims", [x], {"axis": -2}, diff=[0]))
    add(_case("transpose", [x], diff=[0]))
    add(_case("transpose", [x], {"axes": (1, 0, 2)}, diff=[0], tag="axes"))
    add(_case("SwapAxis", [x], {"dim1": 0, "dim2": 2}, diff=[0]))
    add(_case("reshape_like", [x, u(0, 1, 6, 4)], diff=[0]))
    add(_case("Concat", [x, x * 2], {"dim": 2, "num_args": 2}, diff=[0, 1]))
    add(_case("stack", [x, x * 2], {"axis": 1, "num_args": 2}, diff=[0, 1]))
    add(_case("SliceChannel", [u(-1, 1, 2, 6, 3)], {"num_outputs": 3},
              diff=[0]))
    add(_case("SliceChannel", [u(-1, 1, 2, 3, 4)],
              {"num_outputs": 3, "axis": 1, "squeeze_axis": True}, diff=[0],
              tag="squeeze"))
    add(_case("_internal_getitem", [x], {"key": (slice(None), 1)}, diff=[0]))
    add(_case("slice", [x], {"begin": (0, 1, None), "end": (2, 3, None)},
              diff=[0]))
    add(_case("slice", [x], {"begin": (None, 2, 3), "end": (None, 0, 0),
                             "step": (None, -1, -2)}, diff=[0],
              tag="negative steps"))
    add(_case("slice_axis", [x], {"axis": 2, "begin": 1, "end": -1},
              diff=[0]))
    add(_case("slice_like", [x, u(0, 1, 1, 2, 3)], {"axes": (1, 2)},
              diff=[0]))
    add(_case("reverse", [x], {"axis": (0, 2)}, diff=[0]))
    add(_case("tile", [x], {"reps": (2, 1, 2)}, diff=[0]))
    add(_case("tile", [u(-1, 1, 3)], {"reps": (2, 2)}, diff=[0],
              tag="more reps"))
    add(_case("repeat", [x], {"repeats": 2, "axis": 1}, diff=[0]))
    add(_case("repeat", [x], {"repeats": 3}, diff=[0], tag="flat"))
    x4 = u(-1, 1, 1, 2, 4, 5)
    pw = (0, 0, 0, 0, 1, 2, 2, 1)
    add(_case("Pad", [x4], {"mode": "constant", "pad_width": pw,
                            "constant_value": 0.5}, diff=[0]))
    add(_case("Pad", [x4], {"mode": "edge", "pad_width": pw}, diff=[0],
              tag="edge"))
    add(_case("Pad", [x4], {"mode": "reflect", "pad_width": pw}, diff=[0],
              tag="reflect"))
    # products
    a2, b2 = u(-1, 1, 4, 5), u(-1, 1, 5, 3)
    add(_case("dot", [a2, b2], diff=[0, 1], bf16=True))
    add(_case("dot", [a2.T.copy(), b2.T.copy()],
              {"transpose_a": True, "transpose_b": True}, diff=[0, 1],
              bf16=True, tag="transposed"))
    add(_case("dot", [u(-1, 1, 2, 3, 4), u(-1, 1, 4, 5)], diff=[0, 1],
              tag="n-d"))
    add(_case("dot", [u(-1, 1, 4), u(-1, 1, 4)], diff=[0, 1], tag="1-d"))
    ba, bb = u(-1, 1, 2, 4, 5), u(-1, 1, 2, 5, 3)
    add(_case("batch_dot", [ba, bb], diff=[0, 1], bf16=True))
    add(_case("batch_dot", [ba.transpose(0, 2, 1).copy(),
                            bb.transpose(0, 2, 1).copy()],
              {"transpose_a": True, "transpose_b": True}, diff=[0, 1],
              bf16=True, tag="transposed"))
    # indexing
    src = u(-1, 1, 5, 3)
    add(_case("take", [src, np.array([0, 4, 1, 1])], diff=[0]))
    add(_case("take", [u(-1, 1, 2, 5), np.array([[0, 6], [-1, 2]])],
              {"axis": 1, "mode": "wrap"}, diff=[0], tag="wrap"))
    add(_case("take", [src, np.array([0, 7, -2])], {"mode": "clip"},
              diff=[0], tag="clip"))
    add(_case("batch_take", [src, np.array([0, 2, 1, 1, 0])], diff=[0]))
    add(_case("pick", [src, np.array([0, 2, 1, 1, 0])], {"axis": 1},
              diff=[0]))
    add(_case("sparse_retain", [src, np.array([0, 3, 3])], diff=[0]))
    add(_case("cast_storage", [src], {"stype": "default"}, diff=[0]))
    add(_case("Embedding", [np.array([[1, 1], [4, 0]]), u(-1, 1, 5, 3)],
              {"input_dim": 5, "output_dim": 3}, diff=[1]))
    add(_case("one_hot", [np.array([0, 3, 1, 4])],
              {"depth": 5, "on_value": 2.0, "off_value": -1.0}))
    ind = np.array([[0, 2, 3], [1, 4, 0]])
    add(_case("gather_nd", [u(-1, 1, 4, 5), ind], diff=[0]))
    add(_case("scatter_nd", [u(-1, 1, 3), ind], {"shape": (4, 5)},
              diff=[0]))
    add(_case("_scatter_set_nd", [u(-1, 1, 4, 5), ind, u(-1, 1, 3)],
              {"shape": (4, 5)}, diff=[0, 2]))
    # ordering, with ties
    xs = np.round(u(-2, 2, 3, 7) * 2) / 2
    add(_case("sort", [xs], {"axis": 1}, diff=[0]))
    add(_case("sort", [xs], {"axis": 1, "is_ascend": False}, diff=[0],
              tag="descending"))
    add(_case("argsort", [xs], {"axis": 1}))
    add(_case("argsort", [xs], {"axis": 0, "is_ascend": False,
                                "dtype": "int32"}, tag="descending int32"))
    for ret in ("indices", "value", "mask", "both"):
        add(_case("topk", [xs], {"k": 3, "ret_typ": ret},
                  diff=[0] if ret in ("value", "both") else [], tag=ret,
                  seeded=[0]))
    add(_case("topk", [xs], {"k": 2, "axis": 0, "is_ascend": True,
                             "ret_typ": "both"}, diff=[0], tag="ascending",
              seeded=[0]))
    # creation
    add(_case("_zeros", [], {"shape": (2, 3)}))
    add(_case("_ones", [], {"shape": 4, "dtype": "int32"}))
    add(_case("_full", [], {"shape": (2, 2), "value": 1.5}))
    add(_case("_arange", [], {"start": 0.5, "stop": 3.2, "step": 0.3,
                              "repeat": 2}))
    add(_case("_arange", [], {"start": 5}, tag="stop None"))
    add(_case("_eye", [], {"N": 3, "M": 4, "k": 1}))
    add(_case("zeros_like", [x]))
    add(_case("ones_like", [x]))
    add(_case("diag", [u(-1, 1, 4)], {"k": -1}, diff=[0]))
    add(_case("diag", [u(-1, 1, 3, 4)], {"k": 1}, diff=[0], tag="2-d"))
    add(_case("_slice_assign", [u(-1, 1, 4, 5), u(-1, 1, 2, 2)],
              {"begin": (1, 0), "end": (3, 4), "step": (1, 2)},
              diff=[0, 1]))
    add(_case("_crop_assign_scalar", [u(-1, 1, 4, 5)],
              {"begin": (1, 1), "end": (3, 4), "scalar": 2.0}, diff=[0]))
    add(_case("IdentityAttachKLSparseReg", [u(0.1, 0.9, 4, 5)],
              {"sparseness_target": 0.2, "penalty": 0.01}, diff=[0]))
    # neural-network layers
    add(_case("FullyConnected", [u(-1, 1, 4, 2, 3), u(-1, 1, 5, 6),
                                 u(-1, 1, 5)], {"num_hidden": 5},
              diff=[0, 1, 2]))
    add(_case("Convolution", [u(-1, 1, 2, 4, 7, 7), u(-1, 1, 6, 2, 3, 3),
                              u(-1, 1, 6)],
              {"kernel": (3, 3), "num_filter": 6, "num_group": 2,
               "pad": (1, 1)}, diff=[0, 1, 2]))
    for kernel, stride, pad, adj, group, extra in (
            ((3, 3), (2, 2), (1, 1), (1, 1), 1, True),
            ((4, 4), (2, 2), (1, 1), (0, 0), 2, False),
            ((3,), (3,), (0,), (2,), 1, True)):
        c = 4
        shape = (2, c) + (5,) * len(kernel)
        w = u(-1, 1, c, 6 // group, *kernel)
        ins = [u(-1, 1, *shape), w] + ([u(-1, 1, 6)] if extra else [])
        add(_case("Deconvolution", ins,
                  {"kernel": kernel, "stride": stride, "pad": pad,
                   "adj": adj, "num_filter": 6, "num_group": group,
                   "no_bias": not extra}, diff=range(len(ins)),
                  tag="%dd g%d" % (len(kernel), group)))
    add(_case("Pooling", [u(-1, 1, 2, 3, 9)],
              {"kernel": (3,), "stride": (2,), "pad": (1,),
               "pool_type": "avg", "count_include_pad": False}, diff=[0],
              tag="1-d avg"))
    add(_case("Pooling", [u(-1, 1, 2, 3, 9)],
              {"kernel": (3,), "stride": (2,), "pool_type": "sum",
               "pooling_convention": "full"}, diff=[0], tag="1-d sum full"))
    up = u(-1, 1, 1, 2, 3, 4)
    add(_case("UpSampling", [up], {"scale": 2, "sample_type": "nearest",
                                   "num_args": 1}, diff=[0]))
    add(_case("UpSampling", [up, up * 2],
              {"scale": 2, "sample_type": "nearest", "num_args": 2,
               "multi_input_mode": "sum"}, diff=[0, 1], tag="sum"))
    add(_case("UpSampling", [up, up * 2],
              {"scale": 3, "sample_type": "nearest", "num_args": 2},
              diff=[0, 1], tag="concat"))
    add(_case("UpSampling", [up, u(-1, 1, 2, 1, 4, 4)],
              {"scale": 2, "sample_type": "bilinear", "num_args": 2,
               "num_filter": 2}, diff=[0], tag="bilinear"))
    xb = u(-1, 1, 4, 3, 5, 5)
    add(_case("BatchNorm", [xb, u(0.5, 1.5, 3), u(-1, 1, 3), u(-1, 1, 3),
                            u(0.5, 1.5, 3)],
              {"fix_gamma": False, "eps": 1e-5}, diff=[0, 1, 2],
              tol=SUM_TOL))
    add(_case("InstanceNorm", [xb, u(0.5, 1.5, 3), u(-1, 1, 3)],
              {"eps": 1e-5}, diff=[0, 1, 2], tol=SUM_TOL))
    add(_case("LayerNorm", [xb, u(0.5, 1.5, 5), u(-1, 1, 5)], diff=[0, 1, 2],
              tol=SUM_TOL))
    add(_case("LayerNorm", [xb, u(0.5, 1.5, 3), u(-1, 1, 3)], {"axis": 1},
              diff=[0, 1, 2], tol=SUM_TOL, tag="axis 1"))
    for mode in ("instance", "channel", "spatial"):
        add(_case("L2Normalization", [xb], {"mode": mode}, diff=[0],
                  tag=mode))
    add(_case("LRN", [u(0, 1, 2, 7, 3, 3)], {"nsize": 5, "alpha": 1e-2},
              diff=[0]))
    for act in ("relu", "sigmoid", "tanh", "softrelu", "softsign"):
        add(_case("Activation", [u(-2, 2, 3, 4)], {"act_type": act},
                  diff=[0], tag=act))
    xl = u(-2, 2, 2, 3, 4)
    for act in ("leaky", "elu", "selu"):
        add(_case("LeakyReLU", [xl], {"act_type": act, "slope": 0.3},
                  diff=[0], tag=act))
    add(_case("LeakyReLU", [xl, u(0, 0.5, 3)], {"act_type": "prelu"},
              diff=[0, 1], tag="prelu"))
    add(_case("LeakyReLU", [xl], {"act_type": "rrelu"}, diff=[0],
              train=False, tag="rrelu at inference"))
    add(_case("SoftmaxActivation", [xl], diff=[0]))
    add(_case("SoftmaxActivation", [xl], {"mode": "channel"}, diff=[0],
              tag="channel"))
    add(_case("Dropout", [xl], {"p": 0.5}, diff=[0], train=False,
              tag="inference"))
    add(_case("Dropout", [xl], {"p": 0.0}, diff=[0], tag="p 0"))
    logits, labels = u(-2, 2, 4, 5), np.array([0, 3, 1, 4])
    add(_case("SoftmaxOutput", [logits, labels], {"grad_scale": 0.5},
              diff=[0]))
    add(_case("LinearRegressionOutput", [logits, u(-1, 1, 4, 5)],
              {"grad_scale": 2.0}, diff=[0]))
    add(_case("MAERegressionOutput", [logits, u(-1, 1, 4, 5)], diff=[0]))
    add(_case("LogisticRegressionOutput", [logits, idx(2, 4, 5)], diff=[0]))
    add(_case("SVMOutput", [logits, labels], {"margin": 1.5}, diff=[0]))
    add(_case("SVMOutput", [logits, labels], {"use_linear": True,
                                              "regularization_coefficient":
                                              0.5}, diff=[0], tag="linear"))
    add(_case("softmax_cross_entropy", [logits, labels], diff=[0]))
    for norm in ("null", "batch", "valid"):
        add(_case("MakeLoss", [u(-1, 1, 4, 3)],
                  {"normalization": norm, "grad_scale": 0.5}, diff=[0],
                  tag=norm))
    seq, lens = u(-1, 1, 4, 3, 2), np.array([2, 4, 1])
    for op in ("SequenceMask", "SequenceLast", "SequenceReverse"):
        add(_case(op, [seq, lens], {"use_sequence_length": True,
                                    "value": -1.0}, diff=[0]))
        add(_case(op, [seq], diff=[0], tag="whole"))
    add(_case("SequenceMask", [seq.transpose(1, 0, 2).copy(), lens],
              {"use_sequence_length": True, "axis": 1}, diff=[0],
              tag="axis 1"))
    img = u(-1, 1, 2, 3, 6, 7)
    add(_case("Crop", [img], {"offset": (1, 2), "h_w": (3, 4)}, diff=[0]))
    add(_case("Crop", [img], {"h_w": (3, 4), "center_crop": True},
              diff=[0], tag="center"))
    add(_case("Crop", [img, u(0, 1, 1, 1, 4, 4)], {"num_args": 2},
              diff=[0], tag="like"))
    # the fused RNN: each mode at 1 and 2 layers, one and two directions,
    # with and without the state outputs; sums over the time steps in
    # other orders, so SUM_TOL
    t, n, c, h = 5, 3, 4, 6
    for mode, layers, bi, states in (
            ("lstm", 1, False, True), ("lstm", 2, True, False),
            ("lstm", 2, False, True), ("gru", 1, False, True),
            ("gru", 2, True, False), ("gru", 1, True, True),
            ("rnn_tanh", 1, False, True), ("rnn_tanh", 2, True, False),
            ("rnn_relu", 1, False, True), ("rnn_relu", 2, True, False)):
        d = 2 if bi else 1
        ins = [u(-1, 1, t, n, c),
               u(-0.3, 0.3, rnn_param_size(layers, c, h, mode, bi)),
               u(-1, 1, layers * d, n, h)]
        if mode == "lstm":
            ins.append(u(-1, 1, layers * d, n, h))
        add(_case("RNN", ins, {"state_size": h, "num_layers": layers,
                               "bidirectional": bi, "mode": mode,
                               "state_outputs": states},
                  diff=range(len(ins)), tol=SUM_TOL,
                  tag="%s %d layer%s%s%s" % (
                      mode, layers, "s" if layers > 1 else "",
                      " bidirectional" if bi else "",
                      " states" if states else "")))
    _long_tail_cases(add, u, signed, rng)
    return cases


# A gradient through a factorisation (Cholesky, a triangular solve) sums
# products of inverses: two libraries' orders differ by more than an fp32
# sum's few ulps
LINALG_TOL = dict(rtol=1e-4, atol=1e-5)


def _boxes(rng, n, lo=0.0, hi=0.7, size=(0.05, 0.3)):
    """(n, 4) corner boxes inside [0, 1]."""
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(size[0], size[1], (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _long_tail_cases(add, u, signed, rng):
    """The cases of the spatial (nn), linalg (matrix), SSD, R-CNN and
    contrib ops."""
    img = u(-1, 1, 2, 3, 6, 6)
    theta = np.tile(np.array([0.9, 0.1, 0.05, -0.1, 1.1, 0.02]), (2, 1)) \
        + u(-0.05, 0.05, 2, 6)
    add(_case("GridGenerator", [theta], {"transform_type": "affine",
                                         "target_shape": (5, 4)}, diff=[0]))
    add(_case("GridGenerator", [u(-1, 1, 2, 2, 3, 3)],
              {"transform_type": "warp"}, diff=[0], tag="warp"))
    add(_case("BilinearSampler", [img, u(-1.1, 1.1, 2, 2, 4, 3)],
              diff=[0, 1]))
    add(_case("SpatialTransformer", [img, theta],
              {"target_shape": (4, 5), "transform_type": "affine",
               "sampler_type": "bilinear"}, diff=[0, 1]))
    rois = np.array([[0, 1, 1, 6, 5], [1, 0, 2, 7, 7], [0, 2, 3, 4, 4]])
    add(_case("ROIPooling", [u(-1, 1, 2, 3, 8, 8), rois],
              {"pooled_size": (2, 3), "spatial_scale": 1.0}, diff=[0]))
    add(_case("ROIPooling", [u(-1, 1, 2, 3, 8, 8),
                             rois * np.array([1, 2, 2, 2, 2])],
              {"pooled_size": (3, 2), "spatial_scale": 0.5}, diff=[0],
              tag="scale 0.5"))
    a, b = u(-1, 1, 2, 3, 6, 6), u(-1, 1, 2, 3, 6, 6)
    add(_case("Correlation", [a, b], {"max_displacement": 2, "pad_size": 2},
              diff=[0, 1]))
    add(_case("Correlation", [a, b], {"max_displacement": 2, "stride2": 2,
                                      "pad_size": 1, "is_multiply": False},
              diff=[0, 1], tag="abs stride 2"))
    # linalg
    m = u(-1, 1, 2, 4, 4)
    spd = m @ m.transpose(0, 2, 1) + 4 * np.eye(4, dtype=np.float32)
    low = np.linalg.cholesky(spd.astype(np.float64)).astype(np.float32)
    add(_case("_linalg_gemm", [u(-1, 1, 2, 3, 4), u(-1, 1, 2, 5, 4),
                               u(-1, 1, 2, 3, 5)],
              {"transpose_b": True, "alpha": 2.0, "beta": 0.5},
              diff=[0, 1, 2]))
    add(_case("_linalg_gemm2", [u(-1, 1, 2, 4, 3), u(-1, 1, 2, 4, 5)],
              {"transpose_a": True, "alpha": 0.5}, diff=[0, 1]))
    add(_case("_linalg_potrf", [spd], diff=[0], tol=LINALG_TOL))
    add(_case("_linalg_potri", [low], diff=[0], tol=LINALG_TOL))
    for kw in ({}, {"transpose": True}, {"rightside": True},
               {"rightside": True, "transpose": True, "lower": False}):
        tri = low if kw.get("lower", True) else low.transpose(0, 2, 1)
        rhs = u(-1, 1, 2, 3, 4) if kw.get("rightside") else u(-1, 1, 2, 4, 3)
        add(_case("_linalg_trsm", [tri, rhs], dict(kw, alpha=1.5),
                  diff=[0, 1], tol=LINALG_TOL,
                  tag=" ".join(sorted(kw)) or "left"))
    add(_case("_linalg_trmm", [low, u(-1, 1, 2, 4, 3)], {"alpha": 2.0},
              diff=[0, 1]))
    add(_case("_linalg_trmm", [low, u(-1, 1, 2, 3, 4)],
              {"rightside": True, "transpose": True}, diff=[0, 1],
              tag="rightside transpose"))
    add(_case("_linalg_sumlogdiag", [spd], diff=[0]))
    add(_case("_linalg_syrk", [u(-1, 1, 2, 3, 4)], {"alpha": 0.5},
              diff=[0]))
    add(_case("_linalg_syrk", [u(-1, 1, 2, 3, 4)], {"transpose": True},
              diff=[0], tag="transpose"))
    # eigenvectors and the LQ factors are unique up to sign: the outputs
    # are compared with their signs made canonical ("canon"), the gradient
    # only through the eigenvalues, which are sign-free
    add(_case("_linalg_syevd", [spd], diff=[0], seeded=[1], tol=LINALG_TOL,
              canon="syevd"))
    add(_case("_linalg_gelqf", [u(-1, 1, 2, 3, 5)], tol=LINALG_TOL,
              canon="gelqf"))
    # SSD
    add(_case("_contrib_MultiBoxPrior", [np.zeros((1, 2, 4, 5))],
              {"sizes": (0.3, 0.5), "ratios": (1.0, 2.0, 0.5)}))
    add(_case("_contrib_MultiBoxPrior", [np.zeros((1, 2, 3, 3))],
              {"sizes": (0.9,), "ratios": (1.0, 3.0), "clip": True,
               "steps": (0.3, 0.25), "offsets": (0.0, 0.5)},
              tag="clip steps offsets"))
    anchors = np.stack([_boxes(rng, 40, size=(0.1, 0.4))])
    label = np.full((3, 4, 5), -1.0)
    for i, n in enumerate((1, 3, 4)):
        label[i, :n, 0] = rng.randint(0, 3, n)
        label[i, :n, 1:] = _boxes(rng, n, size=(0.15, 0.35))
    cls_pred = u(0, 1, 3, 4, 40)
    add(_case("_contrib_MultiBoxTarget", [anchors, label, cls_pred],
              {"overlap_threshold": 0.4}))
    add(_case("_contrib_MultiBoxTarget", [anchors, label, cls_pred],
              {"overlap_threshold": 0.5, "negative_mining_ratio": 3.0,
               "negative_mining_thresh": 0.3}, tag="mining"))
    prob = u(0.01, 1, 3, 4, 40)
    prob = prob / prob.sum(axis=1, keepdims=True)
    loc = signed(0, 0.3, 3, 160)
    for kw, tag in (({}, ""), ({"nms_topk": 10}, "topk 10"),
                    ({"force_suppress": True, "nms_threshold": 0.3,
                      "threshold": 0.2}, "force")):
        add(_case("_contrib_MultiBoxDetection", [prob, loc, anchors], kw,
                  tag=tag))
    # R-CNN
    cls = u(0, 1, 2, 6, 4, 4)
    bbox = signed(0, 0.1, 2, 12, 4, 4)
    info = np.array([[64, 64, 1.0], [60, 50, 0.8]])
    add(_case("_contrib_Proposal", [cls, bbox, info],
              {"rpn_pre_nms_top_n": 30, "rpn_post_nms_top_n": 10,
               "feature_stride": 16, "scales": (8,), "threshold": 0.5,
               "ratios": (0.5, 1, 2)}))
    add(_case("_contrib_MultiProposal", [cls, bbox, info],
              {"rpn_pre_nms_top_n": 40, "rpn_post_nms_top_n": 20,
               "feature_stride": 16, "scales": (8,), "ratios": (0.5, 1, 2),
               "rpn_min_size": 8, "output_score": True}, tag="scores"))
    ps_data = u(-1, 1, 2, 8, 8, 8)
    ps_rois = np.array([[0, 0, 0, 28, 28], [1, 4, 2, 20, 30],
                        [0, 10, 6, 14, 12]])
    add(_case("_contrib_PSROIPooling", [ps_data, ps_rois],
              {"spatial_scale": 0.25, "output_dim": 2, "pooled_size": 2,
               "group_size": 2}, diff=[0]))
    add(_case("_contrib_DeformablePSROIPooling",
              [ps_data, ps_rois, signed(0, 1, 3, 4, 2, 2)],
              {"spatial_scale": 0.25, "output_dim": 2, "pooled_size": 2,
               "group_size": 2, "trans_std": 0.1}, diff=[0, 2]))
    add(_case("_contrib_DeformablePSROIPooling", [ps_data, ps_rois],
              {"spatial_scale": 0.25, "output_dim": 2, "pooled_size": 2,
               "group_size": 2, "no_trans": True}, diff=[0],
              tag="no trans"))
    add(_case("_contrib_DeformableConvolution",
              [u(-1, 1, 2, 4, 7, 7), signed(0, 0.7, 2, 36, 5, 5),
               u(-1, 1, 6, 2, 3, 3), u(-1, 1, 6)],
              {"kernel": (3, 3), "num_filter": 6, "num_group": 2,
               "num_deformable_group": 2}, diff=[0, 1, 2, 3], tol=SUM_TOL))
    add(_case("_contrib_DeformableConvolution",
              [u(-1, 1, 1, 3, 8, 8), signed(0, 1.5, 1, 18, 4, 4),
               u(-1, 1, 4, 3, 3, 3)],
              {"kernel": (3, 3), "num_filter": 4, "no_bias": True,
               "stride": (2, 2), "pad": (1, 1)}, diff=[0, 1, 2],
              tol=SUM_TOL, tag="stride pad"))
    # contrib
    act = u(-2, 2, 10, 2, 6)
    add(_case("_contrib_CTCLoss", [act, np.array([[1, 2, 0, 0],
                                                  [1, 2, 3, 0]])], diff=[0]))
    add(_case("_contrib_CTCLoss", [act, np.array([[1, 1, 3, -1],
                                                  [2, -1, -1, -1]])],
              {"blank_label": "last"}, diff=[0], tag="blank last"))
    add(_case("_contrib_CTCLoss", [act, np.array([[1, 2, 2, 4],
                                                  [3, 1, 0, 0]]),
                                   np.array([7, 10]), np.array([3, 2])],
              {"use_data_lengths": True, "use_label_lengths": True},
              diff=[0], tag="lengths"))
    # the first row cannot align in 2 steps: the loss is about 1e30 in
    # both packages, and its gradient is rounding noise (not compared)
    add(_case("_contrib_CTCLoss", [act[:2], np.array([[1, 1, 2, 0],
                                                      [1, 0, 0, 0]])],
              tag="infeasible"))
    x = u(-0.5, 1.5, 4, 5)
    add(_case("_contrib_quantize", [x, np.array([0.0]), np.array([1.0])]))
    add(_case("_contrib_quantize", [x, np.array([-1.0]), np.array([2.0])],
              {"out_type": "int8"}, tag="int8"))
    add(_case("_contrib_dequantize", [np.round(u(-127, 127, 4, 5)),
                                      np.array([-1.0]), np.array([2.0])]))
    add(_case("_contrib_fft", [u(-1, 1, 3, 8)], diff=[0]))
    add(_case("_contrib_ifft", [u(-1, 1, 3, 16)], diff=[0]))
    add(_case("_contrib_count_sketch",
              [u(-1, 1, 4, 32), rng.randint(0, 16, (1, 32)),
               rng.choice([-1.0, 1.0], (1, 32))], {"out_dim": 16},
              diff=[0]))


def canonical_signs(kind, outs):
    """Outputs unique up to sign, with their signs made canonical:
    ``syevd``'s rows of U so that each row's largest entry is positive;
    ``gelqf``'s L columns and Q rows so that L's diagonal is positive."""
    if kind == "syevd":
        u = outs[0]
        pick = np.take_along_axis(u, np.abs(u).argmax(-1)[..., None], -1)
        return [u * np.sign(pick)] + outs[1:]
    if kind == "gelqf":
        sign = np.sign(np.diagonal(outs[0], axis1=-2, axis2=-1))
        return [outs[0] * sign[..., None, :], outs[1] * sign[..., :, None]]
    return outs


def run_op_case(pkg, case, ctx, dtype="float32", head_seed=1):
    """Run ``case`` through ``pkg`` (this package or the JAX one) on
    ``ctx``: the visible outputs and the gradients of the inputs in
    ``case["diff"]`` under seeded head gradients, as float64 numpy
    arrays."""
    op = pkg.ops.registry.get_op(case["op"])
    nds = [pkg.nd.array(a, ctx=ctx, dtype=dtype) for a in case["inputs"]]
    attrs = dict(case["attrs"])
    if op.no_inputs:
        attrs["ctx"] = ctx
    diff = case["diff"]
    for i in diff:
        nds[i].attach_grad()
    with pkg.autograd.record(train_mode=case["train"]):
        outs = pkg.nd.invoke(op, nds, attrs)
    if diff:
        rng = np.random.RandomState(head_seed)
        seeded = [outs[i] for i in (case["seeded"] or range(len(outs)))]
        heads = [pkg.nd.array(rng.randn(*o.shape), ctx=ctx, dtype=o.dtype)
                 for o in seeded]
        pkg.autograd.backward(seeded, heads)

    def host(x):
        return np.asarray(x.astype("float64").asnumpy(), np.float64)
    return (canonical_signs(case["canon"], [host(o) for o in outs]),
            [host(nds[i].grad) for i in diff])


def random_cases():
    """One case per random op: (name, draw, mean, var), where
    ``draw(nd, n, ctx)`` takes ``n`` samples through ``nd`` (this package's
    or the JAX package's) on ``ctx`` as an NDArray, and ``mean``/``var`` are
    the distribution's own moments (for the ``_sample_*`` ops, of the
    pooled draws of two parameter rows)."""
    def row(v):
        return np.array(v, np.float32)

    def pooled(means, variances):
        m = float(np.mean(means))
        return m, float(np.mean(np.asarray(variances) + (np.asarray(means)
                                                          - m) ** 2))
    k, p = 3, 0.4
    mu, alpha = 2.0, 0.5
    cases = [
        ("_random_uniform", lambda nd, n, c: nd.random.uniform(
            -1, 3, shape=(n,), ctx=c), 1.0, 16.0 / 12),
        ("_random_normal", lambda nd, n, c: nd.random.normal(
            0.5, 2.0, shape=(n,), ctx=c), 0.5, 4.0),
        ("_random_gamma", lambda nd, n, c: nd.random.gamma(
            2.5, 1.5, shape=(n,), ctx=c), 3.75, 2.5 * 1.5 ** 2),
        ("_random_exponential", lambda nd, n, c: nd.random.exponential(
            2.0, shape=(n,), ctx=c), 2.0, 4.0),
        ("_random_poisson", lambda nd, n, c: nd.random.poisson(
            3.5, shape=(n,), ctx=c), 3.5, 3.5),
        ("_random_negative_binomial", lambda nd, n, c:
         nd.random.negative_binomial(k, p, shape=(n,), ctx=c),
         k * (1 - p) / p, k * (1 - p) / p ** 2),
        ("_random_generalized_negative_binomial", lambda nd, n, c:
         nd.random.generalized_negative_binomial(mu, alpha, shape=(n,),
                                                 ctx=c),
         mu, mu + alpha * mu ** 2),
        ("_random_randint", lambda nd, n, c: nd.random.randint(
            -2, 5, shape=(n,), ctx=c), 1.0, (49 - 1) / 12.0),
        ("_sample_uniform", lambda nd, n, c: nd.random.uniform(
            nd.array(row([0, 2]), ctx=c), nd.array(row([1, 5]), ctx=c),
            shape=(n // 2,)), *pooled([0.5, 3.5], [1 / 12, 9 / 12])),
        ("_sample_normal", lambda nd, n, c: nd.random.normal(
            nd.array(row([-1, 1]), ctx=c), nd.array(row([1, 2]), ctx=c),
            shape=(n // 2,)), *pooled([-1, 1], [1, 4])),
        ("_sample_gamma", lambda nd, n, c: nd.random.gamma(
            nd.array(row([1, 3]), ctx=c), nd.array(row([2, 0.5]), ctx=c),
            shape=(n // 2,)), *pooled([2, 1.5], [4, 0.75])),
        ("_sample_exponential", lambda nd, n, c: nd.random.exponential(
            nd.array(row([1, 3]), ctx=c), shape=(n // 2,)),
         *pooled([1, 1 / 3], [1, 1 / 9])),
        ("_sample_poisson", lambda nd, n, c: nd.random.poisson(
            nd.array(row([1, 6]), ctx=c), shape=(n // 2,)),
         *pooled([1, 6], [1, 6])),
        ("_sample_multinomial", lambda nd, n, c: nd.random.multinomial(
            nd.array(row([0.1, 0.2, 0.3, 0.4]), ctx=c), shape=(n,)),
         2.0, 1.0),
        ("shuffle", lambda nd, n, c: nd.random.shuffle(
            nd.array(np.arange(n, dtype=np.float32) % 10, ctx=c)),
         4.5, 8.25),
    ]
    return cases


def moment_errors(samples, mean, var):
    """How many standard errors the sample mean and variance of
    ``samples`` lie from ``mean`` and ``var`` (the variance's standard
    error from the sample's fourth central moment)."""
    x = np.asarray(samples, np.float64).reshape(-1)
    n = x.size
    m = x.mean()
    c = x - m
    s2 = (c ** 2).mean()
    m4 = (c ** 4).mean()
    return (abs(m - mean) / np.sqrt(var / n),
            abs(s2 - var) / np.sqrt(max(m4 - s2 ** 2, 1e-30) / n))


def set_dropout(block, rate, nn=None):
    """Set every ``nn.Dropout`` under ``block`` to ``rate``.  ``nn`` is
    the Gluon ``nn`` module whose blocks ``block`` is made of: this
    package's by default, the JAX package's for its own."""
    if nn is None:
        from .gluon import nn
    if isinstance(block, nn.Dropout):
        block._rate = rate
    for child in block._children:
        set_dropout(child, rate, nn)


def nms_class_buckets(classes):
    """``nms.cu``'s class_key of each class id: an integral class below
    2**31 in magnitude goes to bucket int(c) & 63, any other (NaN,
    fractional, huge) to 64; ``int64``, on the ids' device."""
    c = classes.double()
    inside = (c < 2.0 ** 31) & (c > -2.0 ** 31)
    v = torch.where(inside, c, torch.zeros_like(c)).to(torch.int64)
    return torch.where(inside & (v.double() == c), v & 63,
                       torch.full_like(v, 64))


def nms_tiled(boxes, classes, alive, trip, threshold, force_suppress=False):
    """The NMS kernels of ``ops/csrc/nms.cu`` in plain PyTorch, step for
    step: (the alive mask after suppression, the scratch words (B, column
    tiles, trip) as ``int64``, the walk's steps).

    ``mask_kernel``: bit r of word (u, i) is box 64u + r's death if box i
    is kept: after i; of its class (any with ``force_suppress``), looked
    for among the columns of i's class bucket (every column where i's
    bucket is 64); and, where both boxes have positive extents and overlap
    strictly in x and y, an IoU (``nms.iou_row``) above ``threshold``,
    elsewhere ``0 > threshold``.  ``walk_kernel``: at step t, tile t-1's
    kept boxes' words of tile t go into removed word t, then tile t's
    candidates (alive, before ``trip``, not removed) are resolved in rounds
    from their diagonal words: those no open candidate suppresses are
    kept, those the kept suppress removed; and tile t-1's kept boxes'
    words of tiles t+1 on go into those tiles' removed words.
    """
    from .ops import nms as nm
    boxes, classes = nm._widen(boxes, classes)
    batch, n = alive.shape
    trip = max(0, min(int(trip), n))
    tile = nm.TILE
    words_n, tiles = -(-n // tile), -(-trip // tile)
    a, g = boxes[:, :trip, None, :], boxes[:, None, :, :]
    ax0, ay0, ax1, ay1 = a.unbind(-1)
    gx0, gy0, gx1, gy1 = g.unbind(-1)
    maybe = ((ax1 > ax0) & (ay1 > ay0) & (gx1 > gx0) & (gy1 > gy0)
             & (ax1 > gx0) & (gx1 > ax0) & (ay1 > gy0) & (gy1 > ay0))
    kill = torch.where(maybe, nm.iou_row(a, g) > threshold,
                       torch.tensor(0.0 > threshold))
    if not force_suppress:
        bucket = nms_class_buckets(classes)
        visited = ((bucket[:, :trip, None] == bucket[:, None, :])
                   | (bucket[:, :trip, None] == 64))
        kill &= visited & (classes[:, :trip, None] == classes[:, None, :])
    kill &= torch.arange(n)[None, :] > torch.arange(trip)[:, None]
    bits = torch.zeros((batch, trip, words_n * tile), dtype=torch.int64)
    bits[..., :n] = kill.long()
    bits = bits.view(batch, trip, words_n, tile)
    words = torch.zeros((batch, trip, words_n), dtype=torch.int64)
    for r in range(tile):
        words |= bits[..., r] << r
    words = words.transpose(1, 2).contiguous()
    assert tuple(words.shape) == nm.scratch_shape(batch, n, trip)

    full = (1 << tile) - 1
    out = torch.zeros_like(alive)
    steps = min(tiles + 1, words_n)
    for b in range(batch):
        m = [[w & full for w in col] for col in words[b].tolist()]
        live = alive[b].tolist()
        removed = [0] * words_n
        kept_prev, ahead = 0, [0] * tile
        for t in range(steps):
            rem = removed[t]
            for r in range(tile):
                if (kept_prev >> r) & 1:
                    rem |= ahead[r]
            keep = 0
            if t < tiles:
                left = min(trip - t * tile, tile)
                diag = [m[t][t * tile + r] if r < left else 0
                        for r in range(tile)]
                open_ = sum(1 << r for r in range(left)
                            if live[t * tile + r]) & ~rem
                while open_:
                    suppressed = 0
                    for r in range(tile):
                        if (open_ >> r) & 1:
                            suppressed |= diag[r]
                    kept_now = open_ & ~suppressed
                    removed_now = 0
                    for r in range(tile):
                        if (kept_now >> r) & 1:
                            removed_now |= diag[r]
                    keep |= kept_now
                    rem |= removed_now
                    open_ &= ~kept_now & ~removed_now
            for u in range(t + 1, words_n):
                for r in range(tile):
                    if (kept_prev >> r) & 1:
                        removed[u] |= m[u][(t - 1) * tile + r]
            removed[t] = rem
            ahead = [m[t + 1][t * tile + r]
                     if t + 1 < words_n and t * tile + r < trip else 0
                     for r in range(tile)]
            kept_prev = keep
        out[b] = torch.tensor(
            [live[j] and not (removed[j // tile] >> (j % tile)) & 1
             for j in range(n)], dtype=torch.bool)
    return out, words, steps


_NOISE_LOCK = threading.Lock()
_NOISE = {}  # (seed, side) -> an N(0, 8) tile the images take windows of


def _noise_tile(seed, side):
    with _NOISE_LOCK:
        if (seed, side) not in _NOISE:
            rng = np.random.default_rng([seed, 1 << 40])
            _NOISE[(seed, side)] = rng.standard_normal(
                (side, side, 3), dtype=np.float32) * 8
        return _NOISE[(seed, side)]


def synthetic_image(seed, index, short=256, classes=1000):
    """(label, HWC uint8 RGB image) number ``index`` of a seeded set that
    looks like a photograph to a JPEG coder: a smooth field (a 6 x 8 grid
    of random colours, interpolated) plus N(0, 8) noise (a window of one
    tile a seed), the shorter side ``short`` and the longer 1 to 1.5 times
    it (a quarter of them upright).  Each image draws from its own
    generator, so any subset is the same images."""
    from .image.image import resize_weights
    rng = np.random.default_rng([seed, index])
    label = int(rng.integers(classes))
    h, w = short, int(round(short * rng.uniform(1.0, 1.5)))
    if rng.random() < 0.25:
        h, w = w, h
    grid = rng.uniform(0, 255, (6, 8, 3))
    field = (resize_weights(6, h, 1) @ grid.reshape(6, 24)).reshape(h, 8, 3)
    field = np.matmul(resize_weights(8, w, 1), field)
    tile = _noise_tile(seed, 2 * short)
    oy, ox = rng.integers(0, 2 * short - h + 1), rng.integers(
        0, 2 * short - w + 1)
    noise = tile[oy:oy + h, ox:ox + w]
    img = np.clip(np.rint(field + noise), 0, 255).astype(np.uint8)
    return label, img


def pil_jpeg(img, quality=95):
    """JPEG bytes of an HWC uint8 RGB image through PIL (the encoder of
    the tests, and of the card's files where its host has no libjpeg)."""
    import io as _pyio
    from PIL import Image
    bio = _pyio.BytesIO()
    Image.fromarray(np.ascontiguousarray(img)).save(bio, format="JPEG",
                                                    quality=quality)
    return bio.getvalue()


CORRUPT_PAYLOAD = b"\x89PNG not a jpeg" * 10


def write_image_rec(prefix, n, seed=0, short=256, classes=1000, quality=95,
                    encode=pil_jpeg, threads=1, corrupt=()):
    """Write ``n`` of :func:`synthetic_image`'s images as JPEG records to
    ``prefix.rec`` and ``prefix.idx`` (header label the image's, id its
    index), encoding on ``threads`` threads; the records at the indices in
    ``corrupt`` carry ``CORRUPT_PAYLOAD`` (not a JPEG) instead.  Returns
    the mean bytes of a record's payload."""
    from concurrent.futures import ThreadPoolExecutor
    from . import recordio

    def one(i):
        label, img = synthetic_image(seed, i, short, classes)
        payload = CORRUPT_PAYLOAD if i in corrupt else encode(img, quality)
        return recordio.pack(recordio.IRHeader(0, float(label), i, 0),
                             payload)

    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    total = 0
    with ThreadPoolExecutor(max(1, threads)) as pool:
        for i, blob in enumerate(pool.map(one, range(n))):
            rec.write_idx(i, blob)
            total += len(blob) - 24
    rec.close()
    return total / max(n, 1)


def loader_batches(n, batch, corrupt=()):
    """The records of each batch ``ImageRecordIter`` gives without shuffle
    over ``n`` records, the ones at the indices in ``corrupt`` dropped
    (``allow_corrupt=True``) and the records after them topping up:
    ``[(record indices, pad), ...]``."""
    kept = [i for i in range(n) if i not in corrupt]
    return [(kept[i:i + batch], batch - len(kept[i:i + batch]))
            for i in range(0, len(kept), batch)]


def write_mnist_idx(path, train=60000, test=10000):
    """MNIST's four idx files under ``path``, of the synthetic digits
    (:func:`_synthetic_digits`, pixels rounded to uint8) at MNIST's sizes
    (``RandomState(42)``, as :func:`get_mnist` draws them), and the
    gzipped pair ``gluon.data.vision.MNIST`` reads; returns ``path``."""
    import gzip
    import os
    from .io import write_idx_file
    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(42)
    protos = rng.rand(10, 28, 28).astype(np.float32)
    parts = (_synthetic_digits(train, rng, protos),
             _synthetic_digits(test, rng, protos))
    names = iter(MNIST_FILES)
    for x, y in parts:
        for arr in (np.rint(x[:, 0] * 255), y):
            name = os.path.join(path, next(names))
            write_idx_file(name, arr.astype(np.uint8))
            with open(name, "rb") as f, \
                    gzip.open(name + ".gz", "wb", compresslevel=1) as g:
                g.write(f.read())
    return path


def rand_ndarray(shape, stype="default", density=None, dtype=None,
                 ctx=None):
    """A random NDArray of storage ``stype`` (``mxnet_tpu/test_utils.py:
    122``): dense uniform in [-1, 1), or :func:`rand_sparse_ndarray`."""
    from . import ndarray as nd
    from .random import host_rng
    if stype == "default":
        return nd.array(host_rng().uniform(-1, 1, shape), ctx=ctx,
                        dtype=dtype or np.float32)
    arr, _ = rand_sparse_ndarray(shape, stype, density=density, dtype=dtype,
                                 ctx=ctx)
    return arr


def rand_sparse_ndarray(shape, stype, density=None, dtype=None,
                        data_init=None, rsp_indices=None, ctx=None):
    """A random sparse NDArray and its dense numpy twin, drawn as
    ``mxnet_tpu/test_utils.py:132-163`` draws them (row_sparse: rows kept
    with probability ``density``, values uniform in [-1, 1); csr: uniform
    in [0, 1), zeroed with probability 1 - ``density``)."""
    from .ndarray import sparse as sp
    from .random import host_rng
    density = 0.5 if density is None else density
    dtype = dtype or np.float32
    if stype == "row_sparse":
        if rsp_indices is not None:
            indices = np.asarray(rsp_indices)
        else:
            indices = np.nonzero(host_rng().random(shape[0]) < density)[0]
        dense = np.zeros(shape, dtype=dtype)
        if len(indices):
            vals = host_rng().uniform(-1, 1, (len(indices),) + shape[1:])
            if data_init is not None:
                vals[:] = data_init
            dense[indices] = vals
            arr = sp.row_sparse_array((dense[indices], indices), shape=shape,
                                      ctx=ctx, dtype=dtype)
        else:
            arr = sp.zeros("row_sparse", shape, ctx=ctx, dtype=dtype)
        return arr, dense
    if stype == "csr":
        rng = host_rng()
        dense = rng.uniform(0, 1, shape).astype(dtype)
        dense[rng.random(shape) >= density] = 0
        return sp.csr_matrix(dense, shape=shape, ctx=ctx, dtype=dtype), dense
    raise ValueError("unknown stype %s" % stype)


def synthetic_libsvm(path, n=2048, dim=1000, nnz=None, density=0.02, seed=7):
    """``examples/sparse_linear_classification.py``'s data: a sparse
    hyperplane over ``dim`` features, ``nnz`` (default ``dim * density``)
    ids a line drawn as ``rng.zipf(1.5) % dim`` and made unique (the
    first ``nnz`` of them sorted, so a few weight rows are hot), values
    uniform in [0, 1), label 1 where the line's dot with the hyperplane
    is positive; the same draws and text as the example."""
    rng = np.random.RandomState(seed)
    w_true = np.zeros(dim)
    support = rng.choice(dim, size=dim // 10, replace=False)
    w_true[support] = rng.randn(len(support))
    nnz = max(1, int(dim * density)) if nnz is None else nnz
    with open(path, "w") as fh:
        for _ in range(n):
            ids = np.unique(rng.zipf(1.5, nnz * 2) % dim)[:nnz]
            vals = rng.rand(len(ids)).astype(np.float32)
            y = int(np.dot(w_true[ids], vals) > 0)
            row = " ".join("%d:%.4f" % (i, v) for i, v in zip(ids, vals))
            fh.write("%d %s\n" % (y, row))


def synthetic_fm_libsvm(path, n=2048, dim=200, nnz=12, seed=3):
    """``examples/factorization_machine.py``'s data: ``nnz`` distinct ids
    a line, the label the sign of a planted pairwise interaction; the
    same draws and text as the example."""
    rng = np.random.RandomState(seed)
    v_true = rng.randn(dim, 4) * 0.6
    with open(path, "w") as fh:
        for _ in range(n):
            ids = rng.choice(dim, size=nnz, replace=False)
            vals = rng.rand(nnz).astype(np.float32)
            x = np.zeros(dim, np.float32)
            x[ids] = vals
            vx = v_true.T @ x
            score = 0.5 * float((vx ** 2).sum() - ((v_true ** 2).T @
                                                   (x ** 2)).sum())
            y = int(score > 0.15)
            row = " ".join("%d:%.4f" % (i, v)
                           for i, v in zip(sorted(ids), x[sorted(ids)]))
            fh.write("%d %s\n" % (y, row))


def _rank_main(rank, world, init_method, backend, device, threads,
               timeout, jobs, results):
    """A rank of a :class:`RankPool`: join the group, then run each job
    ``(fn, args)`` from ``jobs`` until ``None``, putting ``(rank, status,
    payload)`` on ``results``."""
    from .parallel import multihost
    try:
        torch.set_num_threads(threads)
        os.environ.update(MXNET_NUM_PROCESSES=str(world),
                          MXNET_PROCESS_ID=str(rank))
        multihost.init_from_env(force=True, device=device, backend=backend,
                                init_method=init_method, timeout=timeout)
        results.put((rank, "ready", None))
    except BaseException:  # reported to the parent, which stops the pool
        results.put((rank, "error", traceback.format_exc()))
        return
    while True:
        job = jobs.get()
        if job is None:
            break
        fn, args = job
        try:
            results.put((rank, "ok", fn(*args)))
        except BaseException:  # reported to the parent, which stops the pool
            results.put((rank, "error", traceback.format_exc()))
    import torch.distributed as dist
    dist.destroy_process_group()


class RankPool:
    """``world`` ranks of one process group (``backend`` on ``device``),
    started once (within ``START_TIMEOUT_S``): :meth:`run` calls a
    function on every rank.  A failed call (a rank's exception, a rank
    that died, or ``timeout`` seconds passed) terminates every rank, and
    the next call starts them again.
    The rendezvous file lies in a new directory under ``workdir``
    (default: the system's temporary directory), removed at
    :meth:`close`."""

    def __init__(self, world, backend="gloo", device="cpu", timeout=120,
                 threads=1, workdir=None):
        self.world, self.backend, self.device = world, backend, device
        self.timeout, self.threads, self.workdir = timeout, threads, workdir
        self._procs = []
        self._starts = 0

    # spawning a rank imports torch and the package: seconds on a loaded
    # host, which a call's own timeout need not cover
    START_TIMEOUT_S = 180

    def _start(self):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="ranks-", dir=self.workdir)
        self._starts += 1
        init = "file://" + os.path.join(self._dir, "store")
        self._jobs = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, self.world, init, self.backend, self.device,
                  self.threads, self.timeout, self._jobs[r], self._results))
            for r in range(self.world)]
        for p in self._procs:
            p.start()
        self._collect("start", self.START_TIMEOUT_S)

    def _collect(self, what, timeout):
        out = [None] * self.world
        pending = set(range(self.world))
        deadline = time.monotonic() + timeout
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                self.close(grace=0)
                raise MXNetError("%s: ranks %s gave no result within %g s; "
                                 "every rank stopped"
                                 % (what, sorted(pending), timeout))
            try:
                rank, status, payload = self._results.get(
                    timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r in pending
                        if self._procs[r].exitcode is not None]
                if dead:
                    codes = [self._procs[r].exitcode for r in dead]
                    self.close(grace=0)
                    raise MXNetError("%s: ranks %s died (exit codes %s); "
                                     "every rank stopped"
                                     % (what, dead, codes))
                continue
            if status == "error":
                self.close(grace=0)
                raise MXNetError("%s failed on rank %d:\n%s"
                                 % (what, rank, payload))
            out[rank] = payload
            pending.discard(rank)
        return out

    def run(self, fn, *args, timeout=None):
        """``[fn(*args) on rank r for r in range(world)]``."""
        if not self._procs:
            self._start()
        for q in self._jobs:
            q.put((fn, args))
        return self._collect(getattr(fn, "__name__", str(fn)),
                             timeout or self.timeout)

    def close(self, grace=5.0):
        """Stop every rank (those not done within ``grace`` seconds are
        terminated) and remove the rendezvous directory."""
        if not self._procs:
            return
        for q in self._jobs:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        deadline = time.monotonic() + grace
        procs = [p for p in self._procs if p.pid is not None]
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        for q in self._jobs + [self._results]:
            q.cancel_join_thread()
            q.close()
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_ranks(fn, world, backend="gloo", device="cpu", timeout=120,
              args=()):
    """``fn(*args)`` on each of ``world`` new ranks of one process group;
    returns the results in rank order (see :class:`RankPool`)."""
    with RankPool(world, backend, device, timeout) as pool:
        return pool.run(fn, *args)
