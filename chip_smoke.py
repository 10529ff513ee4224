#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mxnet_tpu_torch``) on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA H100 and
``nvcc``:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: require CUDA; print the card's name and power limit.
2. build: compile every CUDA kernel of the port from ``ops/csrc`` with
   nvcc, one process per source, all at once.
3. kernels: each kernel against its plain PyTorch version on the card.
   Flash attention at the parity-test shapes, ragged lengths,
   ``sm_scale=0.5``, D in {16, 32, 64, 128} and the full-width layer
   shape (8, 12, 1024, 64) causal, in fp32 (TF32 off), bf16 and fp16,
   each case both contiguous and as the strided views the model's einsum
   makes (strides (S*H*D, D, H*D, 1)), through whichever kernel
   ``attention.design`` picks (tensor cores for bf16/fp16 at D 64 and
   128, SIMT otherwise);
   the flash-attention backward kernels' dq, dk and dv against
   ``chunked_attention_grads`` at the same cases, dtypes and layouts
   (``do`` strided too where q, k, v are), held to ``BWD_ATOL`` and
   ``BWD_ROW_RTOL``, through whichever kernel ``attention.design_backward``
   picks (tensor cores for bf16/fp16 at D 64 and 128, each such call
   repeated and held bit for bit, SIMT otherwise);
   scale at numel 0, 1, 7, 64 x 128 (the MLP's), 1000003 (also
   misaligned by one element) and 8192 x 8192, alpha 0.5, 3.0, -1.25
   and two that fp32 cannot hold exactly (0.1, 1/3), bit for bit.
   Timings of each kernel, its plain version and one PyTorch call as a
   yardstick (``F.scaled_dot_product_attention``, its backward through
   ``torch.autograd.grad`` less its forward, ``torch.mul``; the port
   never calls any of them), and each attention kernel's bound.
4. LM inference at GPT-2 small widths (12 layers, d_model 768, 12 heads,
   d_ff 3072, vocab 50257, max_len 1024; seeded random weights): 4 batches
   of 8 x 1024 tokens scored to logits and mean next-token NLL, in fp32,
   bf16 and fp16, with the kernel's launch count read around each run.
5. parity: a small LM's logits and NLL on the card (through the kernel)
   against the same params on the CPU (through the plain version), in
   fp32 and in bf16, from three seeds each.
6. registration: ``rtc.register("pl_scale", ...)`` over the scale kernel;
   ``nd.pl_scale`` on a CUDA NDArray and ``sym.sum(sym.pl_scale(...))``
   bound on ``gpu(0)``: forward, backward gives the alpha gradient, one
   launch per forward.
7. MLP training: the MNIST MLP of ``examples/train_mnist.py``
   (784-128-64-10, MXNet's published widths) built with ``sym`` with
   ``pl_scale`` after the first activation, bound with ``simple_bind``,
   trained one epoch (64 steps of 64 synthetic digits) with
   SGD-momentum, then scored on the 1024 test images in fp32 and, with
   the trained weights cast, in bf16; the kernel's launches asserted.
8. MLP parity: 10 steps on the card (through the kernel) against the same
   init on the CPU (through the plain version), fp32, TF32 off.
9. ResNet parity: ``resnet50_v1`` (1000 classes) through ``Module`` at
   batch 2, 3 x 224 x 224, one Module on the card and one on the CPU
   from the same parameters, two ``_fit_step``s each (SGD lr 0.1,
   momentum 0.9, wd 1e-4); the softmax outputs of each step, and the
   parameters and moving statistics after step 2, held to
   ``RESNET_PARITY_TOL``, in fp64 and in fp32 (TF32 off).
10. ResNet-50 training at ``bench.py``'s configuration
   (``_module_train_rate``: the Gluon model lowered to a Symbol, ``Cast``
   to fp32, ``SoftmaxOutput``, ``Module`` at batch 32, Xavier, SGD lr
   0.1, momentum 0.9, wd 1e-4, one seeded batch) in fp32 (TF32 off) and
   bf16: 5 warm-up and 30 timed ``_fit_step``s through
   ``CachedTrainStep``, then 5 + 30 inference forwards; ms/step, img/s
   and the share of the card's peak that 24.6 GFLOP per training image
   (8.2 per inference image) gives.  No hand-written kernel runs on this
   path: its convolutions and products are cuDNN's and cuBLAS's.
11. LM training at GPT-2 small widths (phase 4's configuration, not cut)
   on one seeded batch of 8 x 1024 tokens, in fp32 (TF32 off), bf16 and
   fp16, through ``make_train_step`` (SGD, lr 0.1) and
   ``make_train_step_zero1`` (momentum 0.9): 3 warm-up and 10 timed
   steps each; ms/step, tokens/s and the share of the card's peak at the
   FLOPs counted by ``lm_train_flops``; the loss must stay finite and
   fall, and every step must launch the forward and the backward kernel
   n_layers times each.
12. LM training parity: a small LM (2 layers, d_model 128, 2 heads, so
   D = 64; S = 200) trained 3 steps by each step builder on the card
   (through both kernels) and on the CPU (through the plain versions)
   from one init, in fp32 (TF32 off) and bf16; the loss, the params and
   the momenta held to ``LM_TRAIN_PARITY_TOL`` after each step.

It prints the ResNet-50 numbers as one ``{"resnet50": {...}}`` line, the
LM training numbers as one ``{"lm_train": {...}}`` line and one
``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Without a card, or without the rest
of the repository beside it, it exits non-zero before printing either.
"""
from __future__ import annotations

import itertools
import json
import math
import subprocess
import time

import torch

# atol per dtype.  fp32: the kernel and the plain version both sum in fp32,
# in other orders, over at most 1024 keys.  bf16/fp16: the plain version
# keeps the probabilities P in fp32 and rounds once, at the output; the
# tensor-core kernel also rounds P to the input type before P@V (the form
# wgmma takes), so an output may differ by the two roundings together, a
# unit or two in the last place of outputs of magnitude below 4.  Measured
# on the H100 (PR 3): worst bf16 0.015625, one bf16 ulp at |o| in [2, 4);
# worst fp16 0.00195, one fp16 ulp there.
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 4e-3}
# The atol is set by the early causal rows, where |o| reaches about 4; near
# row 1000 of MAIN_SHAPE |o| is about 0.05, so a kernel wrong only in late
# key tiles could stay under it.  So each row's max|err| is also held
# against that row's largest |ref|.  bf16/fp16: 4 units of roundoff u of
# the type (u = 2^-8 and 2^-11): the two output roundings differ by at most
# one ulp, at most 2u of the row's largest value, and P's rounding (u per
# probability, of no common sign) adds about u more.  fp32: 2^-16, far
# above the few 2^-24 of the summation orders and of expf.
ROW_RTOL = {torch.float32: 2.0 ** -16, torch.bfloat16: 2.0 ** -6,
            torch.float16: 2.0 ** -9}
DTYPE_NAME = {torch.float32: "fp32", torch.bfloat16: "bf16",
              torch.float16: "fp16"}
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# FLOP/s per input type (fp32 outside the tensor cores)
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.float16: 989e12}
MAIN_SHAPE = (8, 12, 1024, 64)
FLASH_CASES = [  # (shape, causal, sm_scale)
    ((2, 3, 64, 16), False, None), ((2, 3, 64, 16), True, None),
    ((1, 2, 48, 16), True, None), ((1, 2, 48, 16), False, None),
    ((1, 1, 16, 16), False, 0.5), ((2, 2, 77, 32), True, None),
    ((2, 4, 200, 64), False, None), ((2, 4, 200, 64), True, 0.5),
    ((1, 3, 130, 128), True, None), ((1, 3, 130, 128), False, None),
    ((1, 1, 1, 64), True, None), (MAIN_SHAPE, True, None),
]
GPT2_SMALL = dict(vocab=50257, d_model=768, n_heads=12, d_ff=3072,
                  n_layers=12, max_len=1024)
LM_BATCH, LM_SEQ, LM_REQUESTS = 8, 1024, 4
SCALE_SHAPES = [(0,), (1,), (7,), (64, 128), (1000003,), (8192, 8192)]
# the last two are not exact in fp32: the kernel gets alpha as a C float,
# the plain version multiplies by a Python float, and both must round it
# to fp32 once before the one multiply
SCALE_ALPHAS = (0.5, 3.0, -1.25, 0.1, 1.0 / 3.0)
SCALE_MAIN_SHAPE = (8192, 8192)
MLP_BATCH, MLP_STEPS, MLP_EVAL_BATCHES, MLP_PARITY_STEPS = 64, 64, 16, 10
MLP_LR, MLP_MOMENTUM, MLP_ALPHA = 0.1, 0.9, 0.5
# Test accuracy of the JAX package after the same 64 steps on the CPU,
# measured by tests/test_torch_mlp_train.py::test_jax_reference_accuracy.
JAX_CPU_ACCURACY = 1.0


def log(*args):
    print(*args, flush=True)


def attention_bound_ms(shape, dtype, causal):
    """Least time for the attention forward on the H100: q, k, v read once
    and o written once over HBM, or 4*D FLOPs per (query, key) pair that the
    mask keeps at the input type's peak, whichever is larger."""
    b, h, s, d = shape
    elem = torch.empty((), dtype=dtype).element_size()
    t_bytes = 4 * b * h * s * d * elem / HBM_BPS
    pairs = s * (s + 1) // 2 if causal else s * s
    t_ops = 4 * d * pairs * b * h / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# About 50 ms at the H100's clock: longer than the host takes to queue
# the timed launches of any cuda_ms call here.
QUEUE_SLEEP_CYCLES = 100_000_000


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events.
    A sleep kernel holds the stream until the host has queued every timed
    launch, so the events time the device's work back to back and a slow
    host does not stretch a short kernel's reading."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log("torch %s, CUDA %s, %d device(s), running on %s"
        % (torch.__version__, torch.version.cuda, torch.cuda.device_count(),
           torch.cuda.get_device_name(0)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from mxnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    seconds = _build.build_all(["flash_attn_fwd", "flash_attn_fwd_sm90",
                                "flash_attn_bwd", "flash_attn_bwd_sm90",
                                "scale"])
    log("build: %s in %.1f s wall" % (seconds, time.perf_counter() - t0))
    for stem in seconds:
        log("ptxas (%s):\n%s" % (stem, _build.build_info(stem)["log"].strip()))


def _qkv(shape, dtype, gen, strided=False):
    """q, k, v [B, H, S, D]: contiguous, or strided as the model's einsum
    makes them (a [B, S, H, D] buffer seen as [B, H, S, D], strides
    (S*H*D, D, H*D, 1))."""
    b, h, s, d = shape
    if strided:
        return [torch.randn((b, s, h, d), generator=gen, device="cuda")
                .to(dtype).transpose(1, 2) for _ in range(3)]
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(3)]


def phase_kernels():
    """Kernel against plain version at every case, contiguous and strided;
    timings at MAIN_SHAPE.  Returns {dtype: {"max_abs_err", "max_row_rel",
    "ms", "strided_ms", "plain_ms", "library_ms", "design"}}."""
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.ops import attention as att
    cases = FLASH_CASES
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            worst = worst_rel = 0.0
            for (shape, causal, scale), strided in itertools.product(
                    cases, (False, True)):
                q, k, v = _qkv(shape, dtype, gen, strided)
                out = att.flash_attention(q, k, v, causal, scale)
                ref = att.flash_attention_reference(q, k, v, causal, scale)
                torch.cuda.synchronize()
                if out.dtype != dtype or out.shape != q.shape:
                    raise AssertionError("kernel output %s %s at %s"
                                         % (out.dtype, tuple(out.shape), shape))
                if not torch.isfinite(out).all():
                    raise AssertionError("non-finite kernel output at %s %s"
                                         % (shape, dtype))
                diff = (out.float() - ref.float()).abs()
                err = diff.max().item()
                # each row's max|err| over that row's largest |ref|
                rel = (diff.amax(-1) / ref.float().abs().amax(-1)
                       .clamp_min(1e-30)).max().item()
                worst, worst_rel = max(worst, err), max(worst_rel, rel)
                log("  %s %-18s %-10s causal=%-5s scale=%-4s %-9s max|err| "
                    "%.3g, row-relative %.3g"
                    % (DTYPE_NAME[dtype], shape,
                       "strided" if strided else "contiguous", causal, scale,
                       att.design(dtype, shape[-1]), err, rel))
                if err > ATOL[dtype] or rel > ROW_RTOL[dtype]:
                    raise AssertionError(
                        "kernel disagrees with plain version at %s %s causal=%s"
                        " scale=%s strided=%s: max|err| %.3g (atol %g), "
                        "row-relative %.3g (limit %g)"
                        % (shape, dtype, causal, scale, strided, err,
                           ATOL[dtype], rel, ROW_RTOL[dtype]))
            q, k, v = _qkv(MAIN_SHAPE, dtype, gen)
            qs, ks, vs = _qkv(MAIN_SHAPE, dtype, gen, strided=True)
            fns = {
                "ms": lambda: att.flash_attention(q, k, v, True),
                "strided_ms": lambda: att.flash_attention(qs, ks, vs, True),
                "plain_ms": lambda: att.flash_attention_reference(
                    q, k, v, True),
                "library_ms":
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=True),
            }
            # three rounds, each timing every function once; the median of
            # each function's three readings, so one slow reading (a clock
            # that has not ramped up yet) decides nothing
            rounds = [{n: cuda_ms(fn) for n, fn in fns.items()}
                      for _ in range(3)]
            timings = {n: sorted(r[n] for r in rounds)[1] for n in fns}
            design = att.design(dtype, MAIN_SHAPE[-1])
            results[dtype] = dict(max_abs_err=worst, max_row_rel=worst_rel,
                                  design=design, **timings)
            log("%s at %s causal (%s): kernel %.4f ms (strided %.4f ms), "
                "plain %.4f ms, SDPA %.4f ms, kernel/SDPA %.2f (medians of "
                "rounds %s), worst max|err| %.3g (atol %g), worst "
                "row-relative %.3g (limit %g) over %d cases"
                % (DTYPE_NAME[dtype], MAIN_SHAPE, design, timings["ms"],
                   timings["strided_ms"], timings["plain_ms"],
                   timings["library_ms"],
                   timings["ms"] / timings["library_ms"],
                   [{n: "%.4f" % t for n, t in r.items()} for r in rounds],
                   worst, ATOL[dtype], worst_rel, ROW_RTOL[dtype],
                   2 * len(cases)))
        # the wrapper refuses what the kernels do not take
        q, k, v = _qkv((1, 2, 64, 64), torch.bfloat16, gen)
        offset = torch.empty(q.numel() + 1, dtype=q.dtype,
                             device="cuda")[1:].view(q.shape)
        for bad in (lambda: att.flash_attention(q.transpose(2, 3), k, v),
                    lambda: att.flash_attention(offset, k, v),
                    lambda: att.flash_attention(q[..., :48].contiguous(),
                                                k[..., :48].contiguous(),
                                                v[..., :48].contiguous()),
                    lambda: att.flash_attention(q.double(), k.double(),
                                                v.double())):
            try:
                bad()
            except MXNetError:
                continue
            raise AssertionError("flash_attention accepted an input it "
                                 "does not take")
    return results


# Backward: the kernel's dq, dk, dv against chunked_attention_grads on the
# card.  Both compute in fp32 from the same loaded values and round once to
# the input type at the end; they differ in the order of their sums (over
# at most 1024 queries or keys) and in where the scale is applied.
# fp32: held at tests/test_pallas.py's gradient atol of 1e-4 (|grads| reach
# about 16 here).  Row by row, each row's max|err| over its largest |ref|
# is held at 2^-8: where one key takes nearly all of a query's
# probability (sm_scale 0.5 spreads the scores 4 times wider), ds =
# p (dp - sum(p dp)) cancels and dq's row is small against the terms it
# sums, so the two summation orders part by up to 7.1e-4 of it (measured
# on the H100 at (2, 4, 200, 64) causal, sm_scale 0.5, with max|err|
# 8.3e-6; 3e-6 or less elsewhere); 2^-8 is five times that and still far
# below the O(1) of a row that a kernel got wrong.
# bf16/fp16: each side's fp32 value rounds once to the type; values that
# differ by that fp32 noise round to the same value or to neighbours one
# ulp apart, and one ulp is at most 2u of the row's largest |ref| (u =
# 2^-8 and 2^-11): row-relative 2^-7 and 2^-10, plus the fp32 rows'
# 2^-8.  Measured: bf16 7.75e-3, fp16 9.7e-4, both at MAIN_SHAPE (the SIMT
# kernel).
# bf16/fp16 at D 64 and 128 go through the tensor-core kernel, which also
# rounds P and dS to the input type where they enter a product (p, dp,
# delta and ds stay fp32).  A CPU model of those two roundings against
# chunked_attention_grads (tools/torch_flash_bwd_cpu_model.py) reads at
# most bf16 0.0094 and fp16 0.0029 at (2, 4, 200, 64) causal sm_scale 0.5
# and (1, 3, 130, 128) causal over ten numpy seeds, under the same limits.
# fp16 rows whose largest |ref| lies below fp16's smallest normal, 2^-14,
# hold subnormal outputs with fewer than 11 bits, so a row's denominator is
# floored at torch.finfo(dtype).tiny (2^-14 for fp16; 1.2e-38 for fp32 and
# bf16, which changes nothing for them).
BWD_ATOL = {torch.float32: 1e-4}
BWD_ROW_RTOL = {torch.float32: 2.0 ** -8,
                torch.bfloat16: 2.0 ** -7 + 2.0 ** -8,
                torch.float16: 2.0 ** -10 + 2.0 ** -8}


BWD_DESIGN_NOTE = {
    "simt": "simt, three passes (row statistics, dq, dk+dv)",
    "wgmma+tma": "wgmma+tma, two launches (row statistics + dq, dk + dv)",
}


def attention_bwd_bound_ms(shape, dtype, causal):
    """Least time for the attention backward on the H100: q, k, v, do read
    once and dq, dk, dv written once over HBM, or the five products of the
    gradient, 10*D FLOPs per (query, key) pair that the mask keeps, at the
    input type's peak, whichever is larger."""
    b, h, s, d = shape
    elem = torch.empty((), dtype=dtype).element_size()
    t_bytes = 7 * b * h * s * d * elem / HBM_BPS
    pairs = s * (s + 1) // 2 if causal else s * s
    t_ops = 10 * d * pairs * b * h / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _grad_errors(got, ref):
    """Largest |err| over dq, dk, dv, and the largest row-relative error of
    each; a row's denominator is its largest |ref|, floored at the smallest
    normal of the grads' dtype (see BWD_ROW_RTOL)."""
    worst, rels = 0.0, []
    for g, r in zip(got, ref):
        diff = (g.float() - r.float()).abs()
        worst = max(worst, diff.max().item())
        floor = torch.finfo(r.dtype).tiny
        rels.append((diff.amax(-1) / r.float().abs().amax(-1)
                     .clamp_min(floor)).max().item())
    return worst, rels


def sdpa_backward_ms(q, k, v, do):
    """SDPA's backward alone, as a yardstick: the time of its forward and
    ``torch.autograd.grad`` together, less its forward's.  The port never
    calls SDPA."""
    F = torch.nn.functional
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def both():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(out, (qg, kg, vg), do)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    return cuda_ms(both) - cuda_ms(fwd)


def phase_kernels_bwd():
    """The backward kernel that ``design_backward`` picks against its plain
    version at every flash case and dtype, q/k/v contiguous and as einsum
    views (do then strided too), and the tensor-core kernel's two calls on
    the same inputs bit for bit; timings at MAIN_SHAPE.  Returns {dtype:
    {"max_abs_err", "max_row_rel", "ms", "strided_ms", "plain_ms",
    "library_ms", "design"}}."""
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.ops import attention as att
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            worst = worst_rel = 0.0
            for (shape, causal, scale), strided in itertools.product(
                    FLASH_CASES, (False, True)):
                q, k, v = _qkv(shape, dtype, gen, strided)
                do = _qkv(shape, dtype, gen, strided)[0]
                got = att.flash_attention_backward(q, k, v, do, causal, scale)
                ref = att.chunked_attention_grads(q, k, v, do, causal, scale)
                if att.design_backward(dtype, shape[-1]) == "wgmma+tma":
                    again = att.flash_attention_backward(q, k, v, do, causal,
                                                         scale)
                    if not all(torch.equal(a, g) for a, g in zip(again, got)):
                        raise AssertionError(
                            "two backward calls on the same inputs differ at "
                            "%s %s causal=%s scale=%s strided=%s"
                            % (shape, dtype, causal, scale, strided))
                torch.cuda.synchronize()
                for g in got:
                    if g.dtype != dtype or g.shape != q.shape:
                        raise AssertionError("backward output %s %s at %s"
                                             % (g.dtype, tuple(g.shape),
                                                shape))
                    if not torch.isfinite(g).all():
                        raise AssertionError("non-finite backward output at "
                                             "%s %s" % (shape, dtype))
                err, rels = _grad_errors(got, ref)
                rel = max(rels)
                worst, worst_rel = max(worst, err), max(worst_rel, rel)
                log("  bwd %s %-18s %-10s causal=%-5s scale=%-4s %-9s max|err| "
                    "%.3g, row-relative %.3g (dq %.3g, dk %.3g, dv %.3g)"
                    % (DTYPE_NAME[dtype], shape,
                       "strided" if strided else "contiguous", causal, scale,
                       att.design_backward(dtype, shape[-1]), err, rel, *rels))
                if err > BWD_ATOL.get(dtype, math.inf) \
                        or rel > BWD_ROW_RTOL[dtype]:
                    raise AssertionError(
                        "backward kernel disagrees with plain version at %s "
                        "%s causal=%s scale=%s strided=%s: max|err| %.3g "
                        "(atol %g), row-relative %.3g (limit %g)"
                        % (shape, dtype, causal, scale, strided, err,
                           BWD_ATOL.get(dtype, math.inf), rel,
                           BWD_ROW_RTOL[dtype]))
            q, k, v = _qkv(MAIN_SHAPE, dtype, gen)
            do = _qkv(MAIN_SHAPE, dtype, gen)[0]
            qs, ks, vs = _qkv(MAIN_SHAPE, dtype, gen, strided=True)
            fns = {
                "ms": lambda: att.flash_attention_backward(q, k, v, do, True),
                "strided_ms": lambda: att.flash_attention_backward(
                    qs, ks, vs, do, True),
                "plain_ms": lambda: att.chunked_attention_grads(
                    q, k, v, do, True),
            }
            rounds = [{n: cuda_ms(fn, iters=10) for n, fn in fns.items()}
                      for _ in range(3)]
            with torch.enable_grad():
                lib = sorted(sdpa_backward_ms(q, k, v, do)
                             for _ in range(3))
            timings = {n: sorted(r[n] for r in rounds)[1] for n in fns}
            timings["library_ms"] = lib[1]
            bound, bound_by = attention_bwd_bound_ms(MAIN_SHAPE, dtype, True)
            design = att.design_backward(dtype, MAIN_SHAPE[-1])
            results[dtype] = dict(max_abs_err=worst, max_row_rel=worst_rel,
                                  design=design, **timings)
            log("bwd %s at %s causal (%s): kernel %.4f ms (strided %.4f ms), "
                "plain %.4f ms, SDPA backward %.4f ms (readings %s), "
                "kernel/SDPA %.2f, bound %.4f ms (%s) (medians of rounds "
                "%s), worst max|err| %.3g (atol %s), worst row-relative "
                "%.3g (limit %g) over %d cases"
                % (DTYPE_NAME[dtype], MAIN_SHAPE, design, timings["ms"],
                   timings["strided_ms"], timings["plain_ms"],
                   timings["library_ms"], ["%.4f" % t for t in lib],
                   timings["ms"] / timings["library_ms"], bound, bound_by,
                   [{n: "%.4f" % t for n, t in r.items()} for r in rounds],
                   worst, BWD_ATOL.get(dtype, "-"), worst_rel,
                   BWD_ROW_RTOL[dtype], 2 * len(FLASH_CASES)))
            del q, k, v, do, qs, ks, vs
        # the wrapper refuses what the kernels do not take
        q, k, v = _qkv((1, 2, 64, 64), torch.bfloat16, gen)
        for bad in (lambda: att.flash_attention_backward(q.transpose(2, 3),
                                                         k, v, q),
                    lambda: att.flash_attention_backward(q, k, v, q[:, :1]),
                    lambda: att.flash_attention_backward(
                        q.double(), k.double(), v.double(), q.double()),
                    lambda: att.flash_attention_backward(q, k, v, q.cpu())):
            try:
                bad()
            except MXNetError:
                continue
            raise AssertionError("flash_attention_backward accepted an input "
                                 "it does not take")
    torch.cuda.empty_cache()
    return results


def phase_lm(dtype):
    """GPT-2-small-width LM inference; returns the kernel launch count of
    the scored run."""
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.ops import attention as att
    cfg = tr.TransformerLMConfig(dtype=dtype, **GPT2_SMALL)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = tr.TransformerLM(cfg, tr.init_transformer_params(gen, cfg))
    n_params = sum(p.numel() for p in model.parameters())
    seqs = [torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ + 1),
                          generator=gen, device="cuda")
            for _ in range(LM_REQUESTS)]
    with torch.inference_mode():
        # warm-up: cuBLAS handles, workspaces, the allocator's logits blocks
        tr.nll_from_logits(model(seqs[0][:, :-1]), seqs[0][:, 1:])
        torch.cuda.synchronize()
        att.reset_launch_count()
        times, nlls = [], []
        for seq in seqs:
            tokens, labels = seq[:, :-1], seq[:, 1:]
            t0 = time.perf_counter()
            logits = model(tokens)
            nll = tr.nll_from_logits(logits, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if logits.shape != (LM_BATCH, LM_SEQ, cfg.vocab):
                raise AssertionError("logits shape %s" % (tuple(logits.shape),))
            if not torch.isfinite(logits).all():
                raise AssertionError("non-finite logits (%s)" % dtype)
            nlls.append(nll.item())
        launches = att.launch_count()
    if not all(math.isfinite(x) for x in nlls):
        raise AssertionError("non-finite NLL %s" % nlls)
    want = cfg.n_layers * LM_REQUESTS
    if launches != want:
        raise AssertionError("flash_attention launched %d times, expected "
                             "n_layers x forwards = %d" % (launches, want))
    ms = 1e3 * sorted(times)[len(times) // 2]
    log("LM %s (%.1f M params, %d layers): %d batches of %dx%d, ms/batch %s"
        " median %.3f, tokens/s %.1f, NLL %s, kernel launches %d"
        % (DTYPE_NAME[dtype], n_params / 1e6, cfg.n_layers, LM_REQUESTS,
           LM_BATCH, LM_SEQ, ["%.3f" % (1e3 * t) for t in times], ms,
           LM_BATCH * LM_SEQ / (ms / 1e3), ["%.4f" % x for x in nlls],
           launches))
    del model, seqs, logits
    torch.cuda.empty_cache()
    return launches


# Card against CPU, small LM (2 layers, S = 200), from each of PARITY_SEEDS:
# logits max|err| and NLL diff.  fp32: sums over d_model/d_ff in cuBLAS's
# order against the CPU's.  bf16: both sides round every activation to
# bf16, at places that differ (cuBLAS and the CPU round a matmul's fp32 sum
# once, but the kernel also rounds P to bf16 before P@V where the plain
# version keeps it in fp32), so a logit of magnitude about 4 may differ by a
# few of its 2^-6 ulps: the logits limit is 0.125, about three times the
# 0.039 measured on the H100 (PR 3).  The NLL averages 400 tokens' errors,
# which have no common sign: a few 1e-2 over sqrt(400) is about 5e-4, and
# the limit is about four times that.
PARITY_SEEDS = (1, 2, 3)
PARITY_TOL = {torch.float32: dict(logits=1e-3, nll=1e-4),
              torch.bfloat16: dict(logits=0.125, nll=2e-3)}


def phase_parity(dtype, seed):
    """Small LM on the card (kernel) against the CPU (plain version)."""
    from mxnet_tpu_torch.models import transformer as tr
    cfg = tr.TransformerLMConfig(vocab=512, d_model=128, n_heads=2, d_ff=256,
                                 n_layers=2, max_len=256, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    cpu_params = tr.init_transformer_params(gen, cfg, device="cpu")
    cuda_params = {n: t.to("cuda") for n, t in cpu_params.items()}
    seq = torch.randint(0, cfg.vocab, (2, 201), generator=gen)
    tokens, labels = seq[:, :-1], seq[:, 1:]
    from mxnet_tpu_torch.ops import attention as att
    att.reset_launch_count()
    with torch.inference_mode():
        ref = tr.transformer_forward(cpu_params, tokens, cfg)
        out = tr.transformer_forward(cuda_params, tokens.cuda(), cfg).cpu()
        nll_ref = tr.nll_from_logits(ref, labels).item()
        nll_out = tr.nll_from_logits(out, labels).item()
    err = (out.float() - ref.float()).abs().max().item()
    tol = PARITY_TOL[dtype]
    log("parity (%s, seed %d, S=200, %s kernel, %d launches): logits "
        "max|err| %.3g (limit %g), NLL cuda %.6f cpu %.6f, |diff| %.3g "
        "(limit %g)"
        % (DTYPE_NAME[dtype], seed,
           att.design(dtype, cfg.d_model // cfg.n_heads), att.launch_count(),
           err, tol["logits"], nll_out, nll_ref, abs(nll_out - nll_ref),
           tol["nll"]))
    if att.launch_count() != cfg.n_layers:
        raise AssertionError("the card's forward launched %d kernels, not %d"
                             % (att.launch_count(), cfg.n_layers))
    if err > tol["logits"] or abs(nll_out - nll_ref) > tol["nll"]:
        raise AssertionError("LM on the card disagrees with the CPU (%s, "
                             "seed %d)" % (DTYPE_NAME[dtype], seed))


# -- LM training (make_train_step, make_train_step_zero1) --------------------
LM_TRAIN_WARMUP, LM_TRAIN_STEPS, LM_TRAIN_LR, LM_TRAIN_MOMENTUM = 3, 10, 0.1, 0.9
LM_TRAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# Small LM trained on the card (through both kernels) and on the CPU
# (through the plain versions) from one init: D = 64, so bf16 takes the
# wgmma+tma forward; S = 200 is ragged against the kernels' 64-row tiles.
LM_TRAIN_PARITY = dict(vocab=256, d_model=128, n_heads=2, d_ff=512,
                       n_layers=2, max_len=256)
LM_TRAIN_PARITY_BATCH, LM_TRAIN_PARITY_SEQ, LM_TRAIN_PARITY_STEPS = 2, 200, 3
LM_TRAIN_PARITY_SEED = 4


def lm_train_parity_init(seed=LM_TRAIN_PARITY_SEED):
    """The parity LM's fp32 params and its batch, on the CPU."""
    from mxnet_tpu_torch.models import transformer as tr
    cfg = tr.TransformerLMConfig(**LM_TRAIN_PARITY)
    gen = torch.Generator().manual_seed(seed)
    params = tr.init_transformer_params(gen, cfg, device="cpu")
    seq = torch.randint(0, cfg.vocab, (LM_TRAIN_PARITY_BATCH,
                                       LM_TRAIN_PARITY_SEQ + 1),
                        generator=gen)
    return params, seq[:, :-1], seq[:, 1:]


def lm_train_run(device, dtype, builder, params, tokens, labels,
                 steps=LM_TRAIN_PARITY_STEPS):
    """``steps`` steps of the parity LM on ``device`` in ``dtype`` from
    ``params`` (cast and copied) through ``builder`` ("plain":
    ``make_train_step``, "zero1": ``make_train_step_zero1``); returns one
    {"loss", "params", "momenta"} per step, fp64 CPU copies."""
    from mxnet_tpu_torch.models import transformer as tr
    cfg = tr.TransformerLMConfig(dtype=dtype, **LM_TRAIN_PARITY)
    # copies: the steps update the params in place
    ps = {n: t.to(device=device, dtype=dtype, copy=True)
          for n, t in params.items()}
    tokens, labels = tr.place_batch(tokens, labels, device)
    if builder == "plain":
        step = tr.make_train_step(cfg, lr=LM_TRAIN_LR, device=device)
        momenta = {}
    else:
        step, momenta = tr.make_train_step_zero1(
            cfg, ps, lr=LM_TRAIN_LR, momentum=LM_TRAIN_MOMENTUM)
    out = []
    for _ in range(steps):
        if builder == "plain":
            ps, loss = step(ps, tokens, labels)
        else:
            ps, momenta, loss = step(ps, momenta, tokens, labels)
        out.append({"loss": loss.item(),
                    "params": {n: t.to("cpu", torch.float64, copy=True)
                               for n, t in ps.items()},
                    "momenta": {n: t.to("cpu", torch.float64, copy=True)
                                for n, t in momenta.items()}})
    return out


def lm_train_diffs(a, b):
    """Per step: |loss difference|, and the largest |difference| of the
    params and of the momenta, between two runs of ``lm_train_run``."""
    def largest(x, y):
        return max(((x[n] - y[n]).abs().max().item() for n in x),
                   default=0.0)
    return [{"loss": abs(sa["loss"] - sb["loss"]),
             "params": largest(sa["params"], sb["params"]),
             "momenta": largest(sa["momenta"], sb["momenta"])}
            for sa, sb in zip(a, b)]


# Card against CPU, the parity LM, 3 steps of each step builder.  On the
# CPU, before any card run (tools/torch_lm_cpu_spread.py), the port's
# runs lie from its fp64 run by at most: fp32 params 1.5e-7, momenta
# 5.3e-8, loss 0 (the loss is fp32 in both); bf16 params 8.9e-3 (about an
# ulp at |p| near 1), momenta 1.8e-3, loss 2.2e-2 (bf16 logits).  A card
# run as accurate as the CPU's lies as far from fp64, so the two lie at
# most twice that apart; the card also differs by its kernels' own
# roundings (the fp32 forward is within 3e-6 of its plain version at
# phase 3's shapes; the bf16 tensor-core forward rounds P to bf16 before
# P@V).  Limits: fp32 params 1e-6, momenta 5e-7, loss 4e-6 (8 ulps of a
# loss near 5.3); bf16 params 2^-5 (4 ulps at |p| in [1, 2)), momenta
# 8e-3, loss 0.1, about 4 times the spread.
LM_TRAIN_PARITY_TOL = {
    torch.float32: dict(loss=4e-6, params=1e-6, momenta=5e-7),
    torch.bfloat16: dict(loss=0.1, params=2.0 ** -5, momenta=8e-3),
}


def phase_lm_train_parity(dtype):
    """The parity LM trained on the card (kernels) and on the CPU (plain
    versions) from one init, 3 steps of each step builder; the loss, the
    params and the momenta held after each step."""
    from mxnet_tpu_torch.ops import attention as att
    flags = tf32_flags() if dtype == torch.float32 else DTYPE_NAME[dtype]
    params, tokens, labels = lm_train_parity_init()
    tol = LM_TRAIN_PARITY_TOL[dtype]
    n_layers = LM_TRAIN_PARITY["n_layers"]
    worst = {}
    for builder in ("plain", "zero1"):
        cpu = lm_train_run("cpu", dtype, builder, params, tokens, labels)
        att.reset_launch_count()
        att.reset_backward_launch_count()
        card = lm_train_run("cuda", dtype, builder, params, tokens, labels)
        launches = (att.launch_count(), att.backward_launch_count())
        want = n_layers * LM_TRAIN_PARITY_STEPS
        diffs = lm_train_diffs(card, cpu)
        for i, d in enumerate(diffs):
            log("LM train parity (%s, %s, S=%d, step %d): loss card %.6f cpu "
                "%.6f, |diff| %.3g (limit %g); params max|diff| %.3g (limit "
                "%g); momenta max|diff| %.3g (limit %g)"
                % (flags, builder, LM_TRAIN_PARITY_SEQ, i + 1,
                   card[i]["loss"], cpu[i]["loss"], d["loss"], tol["loss"],
                   d["params"], tol["params"], d["momenta"],
                   tol["momenta"]))
        if launches != (want, want):
            raise AssertionError("LM train parity on the card launched %s "
                                 "(forward, backward) kernels, not %d each"
                                 % (launches, want))
        bad = [(i + 1, k) for i, d in enumerate(diffs) for k in d
               if d[k] > tol[k]]
        if bad:
            raise AssertionError("LM training on the card disagrees with the "
                                 "CPU (%s, %s) at (step, quantity) %s"
                                 % (DTYPE_NAME[dtype], builder, bad))
        worst[builder] = {k: max(d[k] for d in diffs) for k in diffs[0]}
    torch.cuda.empty_cache()
    return worst


def lm_train_flops(cfg, batch, seq):
    """FLOPs of one training step, counted from the code: 6 x the params
    that enter matrix products (q, k, v, o, w1, w2 per layer and the
    output projection; the embeddings are gathers) x tokens, plus the
    attention: the forward's two products (4*D per (query, key) pair the
    causal mask keeps) and the backward's five (10*D), per head and layer.
    Returns (total, matmul part, attention part)."""
    d, f = cfg.d_model, cfg.d_ff
    matmul_params = cfg.n_layers * (4 * d * d + 2 * d * f) + d * cfg.vocab
    matmul = 6 * matmul_params * batch * seq
    pairs = seq * (seq + 1) // 2
    attn = 14 * (d // cfg.n_heads) * pairs * batch * cfg.n_heads \
        * cfg.n_layers
    return matmul + attn, matmul, attn


def phase_lm_train(dtype):
    """GPT-2-small-width LM training on the card through both step
    builders: LM_TRAIN_WARMUP + LM_TRAIN_STEPS steps on one seeded batch of
    8 x 1024; ms/step, tokens/s and share of peak; the loss must stay
    finite and fall; n_layers forward and n_layers backward launches a
    step.  Returns {builder: {...}} and the kernels' launches."""
    from mxnet_tpu_torch.models import transformer as tr
    from mxnet_tpu_torch.ops import attention as att
    flags = tf32_flags() if dtype == torch.float32 else DTYPE_NAME[dtype]
    cfg = tr.TransformerLMConfig(dtype=dtype, **GPT2_SMALL)
    gen = torch.Generator(device="cuda").manual_seed(0)
    seq = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ + 1),
                        generator=gen, device="cuda")
    tokens, labels = tr.place_batch(seq[:, :-1], seq[:, 1:])
    flops, matmul_flops, attn_flops = lm_train_flops(cfg, LM_BATCH, LM_SEQ)
    out, totals = {}, [0, 0]
    for builder in ("plain", "zero1"):
        params = tr.init_transformer_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        # the steps update params (and momenta) in place
        if builder == "plain":
            step, momenta = tr.make_train_step(cfg, lr=LM_TRAIN_LR), None

            def run():
                return step(params, tokens, labels)[-1]
        else:
            step, momenta = tr.make_train_step_zero1(
                cfg, params, lr=LM_TRAIN_LR, momentum=LM_TRAIN_MOMENTUM)

            def run():
                return step(params, momenta, tokens, labels)[-1]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(LM_TRAIN_WARMUP + LM_TRAIN_STEPS):
            att.reset_launch_count()
            att.reset_backward_launch_count()
            t0 = time.perf_counter()
            losses.append(run())
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            launches = (att.launch_count(), att.backward_launch_count())
            if launches != (cfg.n_layers, cfg.n_layers):
                raise AssertionError(
                    "LM train step (%s, %s) launched %s (forward, backward) "
                    "kernels, not %d each" % (DTYPE_NAME[dtype], builder,
                                              launches, cfg.n_layers))
            totals[0] += launches[0]
            totals[1] += launches[1]
        losses = [x.item() for x in losses]
        ms = sorted(times[LM_TRAIN_WARMUP:])[LM_TRAIN_STEPS // 2]
        res = dict(step_ms_median=ms, step_ms_first=times[:LM_TRAIN_WARMUP],
                   tokens_s=LM_BATCH * LM_SEQ / ms * 1e3,
                   peak_share=flops / (ms / 1e3) / PEAK_FLOPS[dtype],
                   losses=losses,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        out[builder] = res
        log("LM train %s (%s), %s step, %d layers, batch %dx%d: ms/step "
            "median of %d %.3f, first %d %s, %.1f tokens/s, %.2f%% of the %g "
            "TFLOP/s peak at %.4g TFLOP/step (matmul %.4g, attention fwd+bwd "
            "%.4g); loss %s; peak memory %.1f GB; launches per step %d "
            "forward, %d backward"
            % (DTYPE_NAME[dtype], flags, builder, cfg.n_layers, LM_BATCH,
               LM_SEQ, LM_TRAIN_STEPS, ms, LM_TRAIN_WARMUP,
               ["%.1f" % t for t in times[:LM_TRAIN_WARMUP]],
               res["tokens_s"], 100 * res["peak_share"],
               PEAK_FLOPS[dtype] / 1e12, flops / 1e12, matmul_flops / 1e12,
               attn_flops / 1e12, ["%.4f" % x for x in losses],
               res["peak_mem_gb"], cfg.n_layers, cfg.n_layers))
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError("non-finite LM train loss (%s, %s): %s"
                                 % (DTYPE_NAME[dtype], builder, losses))
        if not losses[-1] < losses[0]:
            raise AssertionError("the LM train loss did not fall (%s, %s): "
                                 "%s" % (DTYPE_NAME[dtype], builder, losses))
        del params, momenta, step, run
        torch.cuda.empty_cache()
    return out, tuple(totals)


def scale_bound_ms(numel, dtype):
    """Least time for the scale: each element read once and written once
    over HBM (one multiply each is far below the operation bound)."""
    elem = torch.empty((), dtype=dtype).element_size()
    return 1e3 * 2 * numel * elem / HBM_BPS, "bytes"


def phase_scale_kernel():
    """The scale kernel against its plain version, bit for bit, at every
    case; timings at SCALE_MAIN_SHAPE.  Returns {dtype: {"max_abs_err",
    "ms", "plain_ms", "library_ms"}}."""
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.ops import scale as sc
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            worst, n_cases = 0.0, 0
            for shape in SCALE_SHAPES:
                base = torch.randn(shape, generator=gen, device="cuda")
                xs = [base.to(dtype)]
                if base.numel() == 1000003:  # 2 bytes or 4 off 16-byte
                    xs.append(xs[0].view(-1)[1:])
                for x in xs:
                    for alpha in SCALE_ALPHAS:
                        out = sc.scale(x, alpha)
                        ref = sc.scale_reference(x, alpha)
                        torch.cuda.synchronize()
                        if out.dtype != dtype or out.shape != x.shape:
                            raise AssertionError("scale output %s %s at %s"
                                                 % (out.dtype,
                                                    tuple(out.shape), shape))
                        err = (out.float() - ref.float()).abs().max().item() \
                            if x.numel() else 0.0
                        worst = max(worst, err)
                        if not torch.equal(out, ref):
                            raise AssertionError(
                                "scale kernel differs from its plain version"
                                " at %s %s alpha=%s: max|err| %.3g"
                                % (tuple(x.shape), DTYPE_NAME[dtype], alpha,
                                   err))
                        n_cases += 1
            x = torch.randn(SCALE_MAIN_SHAPE, generator=gen,
                            device="cuda").to(dtype)
            # the kernel and torch.mul are within 1% of each other: time
            # them in turns (kernel, mul, mul, kernel) and take the means
            turns = [cuda_ms(fn, iters=50) for fn in (
                lambda: sc.scale(x, MLP_ALPHA),
                lambda: torch.mul(x, MLP_ALPHA),
                lambda: torch.mul(x, MLP_ALPHA),
                lambda: sc.scale(x, MLP_ALPHA))]
            timings = {
                "ms": (turns[0] + turns[3]) / 2,
                "plain_ms": cuda_ms(lambda: sc.scale_reference(x, MLP_ALPHA)),
                "library_ms": (turns[1] + turns[2]) / 2,
            }
            results[dtype] = dict(max_abs_err=worst, **timings)
            log("scale %s: %d cases bitwise equal; at %s: kernel %.4f ms "
                "(turns %s), plain %.4f ms, torch.mul %.4f ms, bound %.4f ms"
                % (DTYPE_NAME[dtype], n_cases, SCALE_MAIN_SHAPE,
                   timings["ms"], ["%.4f" % t for t in turns],
                   timings["plain_ms"], timings["library_ms"],
                   scale_bound_ms(x.numel(), dtype)[0]))
            del x
        x = torch.randn((64, 128), generator=gen, device="cuda")
        for bad in (lambda: sc.scale(x.t(), 2.0),
                    lambda: sc.scale(x.double(), 2.0)):
            try:
                bad()
            except MXNetError:
                continue
            raise AssertionError("scale accepted an input it does not take")
    torch.cuda.empty_cache()
    return results


# -- the MNIST MLP through the registered kernel ------------------------------
def scale_grad(out_grads, inputs, outputs, attrs):
    """pl_scale's semantic gradient (tests/test_pallas_register.py:40-41)."""
    return (out_grads[0] * float(attrs.get("alpha", 2.0)),)


def register_pl_scale():
    """Register the scale kernel as the user kernel ``pl_scale``, as a user
    of ``rtc`` would: the kernel, or its plain body where the registry
    fills ``interpret=True`` (CPU and meta tensors)."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops.scale import scale, scale_reference

    def pl_scale(x, alpha=2.0, interpret=False):
        return scale_reference(x, alpha) if interpret else scale(x, alpha)
    return rtc.register("pl_scale", pl_scale, grad=scale_grad, force=True)


def build_mlp(S):
    """``examples/train_mnist.py::build_mlp`` (784-128-64-10) with the
    registered kernel after the first activation, in the namespace ``S``."""
    net = S.Flatten(S.Variable("data"))
    net = S.FullyConnected(net, num_hidden=128, name="fc1")
    net = S.Activation(net, act_type="relu")
    net = S.pl_scale(net, alpha=MLP_ALPHA)
    net = S.FullyConnected(net, num_hidden=64, name="fc2")
    net = S.Activation(net, act_type="relu")
    net = S.FullyConnected(net, num_hidden=10, name="fc3")
    return S.SoftmaxOutput(net, name="softmax")


def param_names(exe):
    return [n for n in exe.arg_names if n not in ("data", "softmax_label")]


def bind_mlp(ctx, dtype=torch.float32):
    from mxnet_tpu_torch import sym
    return build_mlp(sym).simple_bind(
        ctx, grad_req="write", type_dict={"data": dtype},
        data=(MLP_BATCH, 784), softmax_label=(MLP_BATCH,))


def init_mlp(exe, seed=0):
    """Xavier (uniform, avg, magnitude 3) weights and zero biases, drawn
    from the executor's device generator after ``random.seed(seed)``."""
    import mxnet_tpu_torch as mt
    mt.random.seed(seed)
    init = mt.init.Xavier()
    for n in param_names(exe):
        init(mt.init.InitDesc(n), exe.arg_dict[n])


def _sync(exe):
    if exe.arg_dict["data"].context.device_type == "gpu":
        torch.cuda.synchronize()


def train_mlp(exe, x, y, steps):
    """``steps`` SGD-momentum steps over consecutive batches of the NDArrays
    x (N, 784) and y (N,): forward(is_train=True), backward(), one update
    per parameter, the loop ``Module.fit`` runs, and nothing else inside
    the clock.  Returns each step's softmax output (a tensor on the
    executor's device, made anew by each forward; ``batch_losses`` turns
    them into losses after the loop) and the seconds of each step (the
    clock stops after a synchronize)."""
    import mxnet_tpu_torch as mt
    upd = mt.optimizer.Updater(mt.optimizer.SGD(
        learning_rate=MLP_LR, momentum=MLP_MOMENTUM,
        rescale_grad=1.0 / MLP_BATCH))
    params = param_names(exe)
    probs, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        sl = slice(i * MLP_BATCH, (i + 1) * MLP_BATCH)
        exe.forward(is_train=True, data=x[sl], softmax_label=y[sl])
        exe.backward()
        for j, n in enumerate(params):
            upd(j, exe.grad_dict[n], exe.arg_dict[n])
        probs.append(exe.outputs[0]._data)
        _sync(exe)
        times.append(time.perf_counter() - t0)
    return probs, times


def batch_losses(probs, y):
    """Mean negative log-likelihood of each step's batch, from the softmax
    outputs of ``train_mlp`` and the labels y (N,): a (steps,) tensor."""
    labels = y._data[:len(probs) * MLP_BATCH].long().view(len(probs), -1, 1)
    picked = torch.stack(probs).float().gather(2, labels).squeeze(2)
    return -torch.log(picked).mean(dim=1)


def eval_mlp(exe, x, y):
    """Accuracy over consecutive batches with forward(is_train=False)."""
    correct = 0
    n = x.shape[0] // MLP_BATCH
    for i in range(n):
        sl = slice(i * MLP_BATCH, (i + 1) * MLP_BATCH)
        prob = exe.forward(is_train=False, data=x[sl])[0]._data
        correct += (prob.argmax(dim=1) == y[sl]._data.long()).sum()
    return float(correct) / (n * MLP_BATCH)


def phase_registration():
    """rtc on the card: eager and bound calls launch the kernel once per
    forward, and the bound graph's backward gives the alpha gradient."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd, sym
    from mxnet_tpu_torch.ops import scale as sc
    register_pl_scale()
    gpu = mt.gpu(0)
    x = nd.array(torch.arange(6.0).reshape(2, 3).numpy(), ctx=gpu)
    sc.reset_launch_count()
    y = nd.pl_scale(x, alpha=3.0)
    if sc.launch_count() != 1 or not torch.equal(
            y._data, x._data * 3.0) or y.context != gpu:
        raise AssertionError("nd.pl_scale on the card: launches %d, %s"
                             % (sc.launch_count(), y.asnumpy()))
    ex = sym.sum(sym.pl_scale(sym.Variable("d"), alpha=5.0)).simple_bind(
        gpu, grad_req="write", d=(2, 3))
    ex.arg_dict["d"][:] = 1.0
    sc.reset_launch_count()
    out = ex.forward(is_train=True)[0]
    if sc.launch_count() != 1:
        raise AssertionError("bound forward launched %d times"
                             % sc.launch_count())
    ex.backward()
    ex.forward(is_train=False)
    grad = ex.grad_dict["d"].asnumpy()
    if sc.launch_count() != 2 or float(out.asnumpy()) != 30.0 \
            or not (grad == 5.0).all():
        raise AssertionError("bound pl_scale: launches %d, out %s, grad %s"
                             % (sc.launch_count(), out.asnumpy(), grad))
    log("registration: nd.pl_scale and sym.pl_scale on %s launch once per "
        "forward; d/dx sum(5x) = %s" % (gpu, grad.ravel().tolist()))


def _mnist_on(ctx):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd
    blob = mt.test_utils.get_mnist()
    return [nd.array(blob[k].reshape(blob[k].shape[0], -1) if "data" in k
                     else blob[k], ctx=ctx)
            for k in ("train_data", "train_label", "test_data", "test_label")]


def phase_mlp():
    """One epoch of the MLP on the card through the scale kernel, then the
    test images scored in fp32 and in bf16.  Returns the kernel's
    launches in each dtype's run."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import scale as sc
    register_pl_scale()
    gpu = mt.gpu(0)
    x, y, xt, yt = _mnist_on(gpu)
    exe = bind_mlp(gpu)
    init_mlp(exe)
    sc.reset_launch_count()
    probs, times = train_mlp(exe, x, y, MLP_STEPS)
    acc = eval_mlp(exe, xt, yt)
    launches_fp32 = sc.launch_count()
    losses = batch_losses(probs, y).tolist()
    ms = sorted(1e3 * t for t in times)[len(times) // 2]
    log("MLP fp32 on %s: %d steps of %d, ms/step median %.3f, first 5 %s; "
        "loss at steps 1, 32, 64: %.6f %.6f %.6f; test accuracy %.4f "
        "(JAX on the CPU %.4f); scale launches %d"
        % (gpu, MLP_STEPS, MLP_BATCH, ms,
           ["%.3f" % (1e3 * t) for t in times[:5]], losses[0], losses[31],
           losses[63], acc, JAX_CPU_ACCURACY, launches_fp32))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite MLP loss %s" % losses)
    if not losses[-1] < losses[0]:
        raise AssertionError("the MLP loss did not fall: %s" % losses)
    if acc < JAX_CPU_ACCURACY - 0.02:
        raise AssertionError("MLP test accuracy %.4f below %.4f - 0.02"
                             % (acc, JAX_CPU_ACCURACY))
    want = MLP_STEPS + MLP_EVAL_BATCHES
    if launches_fp32 != want:
        raise AssertionError("scale launched %d times, expected train "
                             "forwards + eval batches = %d"
                             % (launches_fp32, want))
    bf16 = bind_mlp(gpu, torch.bfloat16)
    bf16.copy_params_from({n: exe.arg_dict[n] for n in param_names(exe)})
    sc.reset_launch_count()
    acc_bf16 = eval_mlp(bf16, xt.astype(torch.bfloat16), yt)
    launches_bf16 = sc.launch_count()
    log("MLP bf16 scoring of the trained weights: test accuracy %.4f, "
        "scale launches %d" % (acc_bf16, launches_bf16))
    if launches_bf16 != MLP_EVAL_BATCHES or acc_bf16 < JAX_CPU_ACCURACY - 0.02:
        raise AssertionError("bf16 MLP scoring: accuracy %.4f, launches %d"
                             % (acc_bf16, launches_bf16))
    return {torch.float32: launches_fp32, torch.bfloat16: launches_bf16}


def phase_mlp_parity():
    """10 MLP steps on the card (kernel) against the CPU (plain version)
    from one init, fp32."""
    import mxnet_tpu_torch as mt
    register_pl_scale()
    runs, init = [], None
    for ctx in (mt.cpu(), mt.gpu(0)):
        exe = bind_mlp(ctx)
        if init is None:
            init_mlp(exe)
            init = {n: exe.arg_dict[n].copy() for n in param_names(exe)}
        else:
            exe.copy_params_from(init)
        x, y, _, _ = _mnist_on(ctx)
        probs, _ = train_mlp(exe, x, y, MLP_PARITY_STEPS)
        runs.append((exe, batch_losses(probs, y).cpu()))
    (cpu_exe, cpu_loss), (gpu_exe, gpu_loss) = runs
    loss_err = (gpu_loss - cpu_loss).abs().max().item()
    w_err = max((gpu_exe.arg_dict[n]._data.cpu()
                 - cpu_exe.arg_dict[n]._data).abs().max().item()
                for n in param_names(cpu_exe))
    log("MLP parity (fp32, %d steps): loss max|err| %.3g, weights max|err| "
        "%.3g" % (MLP_PARITY_STEPS, loss_err, w_err))
    # fp32 sums in cuBLAS's order against the CPU's, through 10 updates
    if loss_err > 1e-5 or w_err > 1e-4:
        raise AssertionError("MLP on the card disagrees with the CPU")


# -- ResNet-50 through Module (bench.py:107-152) ------------------------------
RESNET_BATCH, RESNET_IMAGE, RESNET_WARMUP, RESNET_STEPS = 32, 224, 5, 30
RESNET_LR, RESNET_MOMENTUM, RESNET_WD = 0.1, 0.9, 1e-4
# bench.py's analytic FLOPs per image: forward 2 x 4.1 GMAC, training 3x
RESNET_FWD_FLOPS, RESNET_TRAIN_FLOPS = 8.2e9, 24.6e9
RESNET_PARITY_BATCH = 2
# Card against CPU, two steps of ResNet-50 at batch 2 from one init.  One
# SGD step at lr 0.1 on a batch of 2 moves some weights by 4.7 and makes
# the second step's results depend on the first's rounding about 1e8
# times over.  On the CPU, before any run on the card
# (tools/torch_resnet_cpu_spread.py, largest |differences|: step-1
# outputs, step-2 outputs, parameters and moving statistics after step 2,
# relative to max(1, |v|)): the JAX package against this one in fp64
# 1.5e-15, 1.5e-8, 1.3e-7 and 5.7e-8; in fp32 3.4e-7, 0.039, 0.42 and
# 0.098; the JAX package's own fp32 against its fp64 5.9e-7, 0.20, 0.62
# and 0.10.  So:
# - fp64 holds the arithmetic: step 1's outputs (no update yet) 1e-10,
#   everything after an update 1e-5, about 100 times the CPU's fp64
#   spread, on the largest |difference|;
# - fp32 holds step 1's outputs to 1e-4: the forward before any update,
#   where TF32 or a dtype slip would show.  After an update an fp32 run
#   lands wherever its own rounding, amplified, puts it: the script
#   prints how far the card's and the CPU's fp32 runs each land from
#   their fp64 runs and from each other, and holds none of it: two fp32
#   runs as accurate as each other still land apart by whatever the
#   amplified roundings give (PERF.md has the card's readings).
RESNET_PARITY_TOL = {
    torch.float64: dict(out1=1e-10, params1=1e-5, out2=1e-5, params2=1e-5,
                        aux2=1e-5),
    torch.float32: dict(out1=1e-4),
}


def tf32_flags():
    """Turn TF32 off for an fp32 phase and say so."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ("TF32 off (cuda.matmul.allow_tf32=%s, cudnn.allow_tf32=%s)"
            % (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32))


def resnet_module(ctx, batch, dtype=torch.float32, image=RESNET_IMAGE,
                  model="resnet50_v1", classes=1000, **model_kw):
    """``bench.py::_module_train_rate``'s model, bound: the zoo model (cast
    to ``dtype``) lowered to a Symbol, ``Cast`` to fp32 (fp64 stays fp64),
    ``SoftmaxOutput(name="softmax")``, a ``Module`` on ``ctx`` bound at
    ``batch`` x 3 x image x image; no parameters yet."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import sym
    from mxnet_tpu_torch.io import DataDesc
    with mt.name.NameManager():
        net = mt.gluon.model_zoo.vision.get_model(model, classes=classes,
                                                  **model_kw)
    if dtype != torch.float32:
        net.cast(str(dtype).replace("torch.", ""))
    out_dtype = "float64" if dtype == torch.float64 else "float32"
    out = sym.Cast(net(sym.Variable("data")), dtype=out_dtype)
    out = sym.SoftmaxOutput(out, sym.Variable("softmax_label"),
                            name="softmax")
    mod = mt.mod.Module(out, context=ctx)
    mod.bind(data_shapes=[DataDesc("data", (batch, 3, image, image),
                                   dtype=dtype)],
             label_shapes=[DataDesc("softmax_label", (batch,),
                                    dtype=out_dtype)])
    return mod


def resnet_train_setup(mod, params=None):
    """Xavier init after ``random.seed(0)`` (or ``params``, a
    ``get_params()`` pair), then SGD lr 0.1, momentum 0.9, wd 1e-4."""
    import mxnet_tpu_torch as mt
    if params is None:
        mt.random.seed(0)
        mod.init_params(initializer=mt.initializer.Xavier())
    else:
        mod.set_params(*params)
    mod.init_optimizer(optimizer="sgd", optimizer_params=(
        ("learning_rate", RESNET_LR), ("momentum", RESNET_MOMENTUM),
        ("wd", RESNET_WD)))


def resnet_batch(ctx, batch, dtype, image=RESNET_IMAGE, classes=1000,
                 label_dtype=torch.float32):
    """One ``DataBatch`` from ``RandomState(0)``, as bench.py makes it."""
    import numpy as np
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.io import DataBatch
    rng = np.random.RandomState(0)
    return DataBatch(
        [nd.array(rng.rand(batch, 3, image, image).astype(np.float32),
                  ctx=ctx, dtype=dtype)],
        [nd.array(rng.randint(0, classes, (batch,)).astype(np.float32),
                  ctx=ctx, dtype=label_dtype)])


def _resnet_two_steps(ctx, dtype, params):
    """Two ``_fit_step``s at batch 2; returns {"out1", "params1", "out2",
    "params2", "aux2"}: each step's outputs and the parameters after it,
    and the moving statistics after step 2, as fp64 CPU tensors."""
    mod = resnet_module(ctx, RESNET_PARITY_BATCH, dtype)
    resnet_train_setup(mod, params)
    label_dt = torch.float64 if dtype == torch.float64 else torch.float32
    db = resnet_batch(ctx, RESNET_PARITY_BATCH, dtype, label_dtype=label_dt)
    res = {}
    for step in (1, 2):
        mod._fit_step(db)
        arg, aux = mod.get_params()
        res["out%d" % step] = mod.get_outputs()[0]._data.to("cpu",
                                                            torch.float64)
        res["params%d" % step] = {n: a._data.to(torch.float64)
                                  for n, a in arg.items()}
    res["aux2"] = {n: a._data.to(torch.float64) for n, a in aux.items()}
    if mod._cached_step is None:
        raise AssertionError("the parity steps did not take CachedTrainStep")
    return res


def _cast_params(params, dtype):
    from mxnet_tpu_torch import nd
    import mxnet_tpu_torch as mt
    return [{n: nd.NDArray(a._data.to(dtype), mt.cpu()) for n, a in d.items()}
            for d in params]


def _resnet_diffs(a, b, l2=False):
    """Distances between two runs of ``_resnet_two_steps``, the moving
    statistics relative to max(1, |v|): each the largest |a - b|, or with
    ``l2`` the root of its summed squares."""
    def dist(pairs):
        d = torch.cat([(u - v).flatten() for u, v in pairs])
        return (d.norm() if l2 else d.abs().max()).item()
    out = {}
    for key, va in a.items():
        vb = b[key]
        if key == "aux2":
            scale = {n: v.abs().clamp_min(1.0) for n, v in va.items()}
            va = {n: v / scale[n] for n, v in va.items()}
            vb = {n: v / scale[n] for n, v in vb.items()}
        pairs = [(va[n], vb[n]) for n in va] if isinstance(va, dict) \
            else [(va, vb)]
        out[key] = dist(pairs)
    return out


def phase_resnet_parity():
    """ResNet-50 through Module on the card against the CPU, two steps
    from one init, fp64 then fp32 (TF32 off)."""
    import mxnet_tpu_torch as mt
    flags = tf32_flags()
    init = mt.cpu()
    mod = resnet_module(init, RESNET_PARITY_BATCH)
    resnet_train_setup(mod)
    params = mod.get_params()
    runs = {}
    for dtype in (torch.float64, torch.float32):
        p = _cast_params(params, dtype)
        # (CPU, card)
        runs[dtype] = [_resnet_two_steps(ctx, dtype, p)
                       for ctx in (mt.cpu(), mt.gpu(0))]
    diffs = {dt: _resnet_diffs(r[1], r[0]) for dt, r in runs.items()}
    (cpu32, gpu32), (cpu64, gpu64) = runs[torch.float32], runs[torch.float64]
    fp32 = {"card-cpu": diffs[torch.float32],
            "card-card64": _resnet_diffs(gpu32, gpu64),
            "cpu-cpu64": _resnet_diffs(cpu32, cpu64)}
    fp32_l2 = {"card-cpu": _resnet_diffs(gpu32, cpu32, l2=True),
               "card-card64": _resnet_diffs(gpu32, gpu64, l2=True),
               "cpu-cpu64": _resnet_diffs(cpu32, cpu64, l2=True)}
    tol64, tol32 = RESNET_PARITY_TOL[torch.float64], \
        RESNET_PARITY_TOL[torch.float32]

    def fmt(d):
        return {k: "%.3g" % v for k, v in d.items()}
    log("ResNet-50 parity, batch %d, 2 steps, card against CPU: fp64 largest "
        "|diff| %s (limits %s); fp32, %s: card against CPU step-1 outputs "
        "%.3g (limit %g)"
        % (RESNET_PARITY_BATCH, fmt(diffs[torch.float64]), tol64, flags,
           diffs[torch.float32]["out1"], tol32["out1"]))
    for name in fp32:
        log("  fp32 %-11s largest |diff| %s, root-sum-square %s"
            % (name, fmt(fp32[name]), fmt(fp32_l2[name])))
    bad = [k for k, v in diffs[torch.float64].items() if v > tol64[k]]
    if diffs[torch.float32]["out1"] > tol32["out1"]:
        bad.append("fp32 out1")
    if bad:
        raise AssertionError("ResNet-50 on the card disagrees with the CPU: "
                             "%s" % bad)
    return dict(fp64=diffs[torch.float64], fp32=fp32, fp32_l2=fp32_l2)

def _timed(fn, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def phase_resnet_train(dtype):
    """bench.py's ResNet-50 training step at batch 32 on the card: ms/step,
    img/s, inference img/s and the share of peak."""
    import mxnet_tpu_torch as mt
    flags = tf32_flags() if dtype == torch.float32 else "bf16"
    gpu = mt.gpu(0)
    mod = resnet_module(gpu, RESNET_BATCH, dtype)
    resnet_train_setup(mod)
    db = resnet_batch(gpu, RESNET_BATCH, dtype)
    ex = mod._exec_group.execs[0]
    stat = next(n for n in ex.aux_names if n.endswith("running_mean"))
    before = ex.aux_dict[stat]._data.clone()
    torch.cuda.reset_peak_memory_stats()
    warm = _timed(lambda: mod._fit_step(db), RESNET_WARMUP)
    if mod._cached_step is None:
        raise AssertionError("ResNet-50 step fell off CachedTrainStep")
    times = _timed(lambda: mod._fit_step(db), RESNET_STEPS)
    prob = mod.get_outputs()[0]._data
    label = db.label[0]._data.long()
    loss = -torch.log(prob.float().gather(1, label[:, None])).mean().item()
    moved = (ex.aux_dict[stat]._data != before).any().item()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd = _timed(lambda: mod.forward(db, is_train=False), RESNET_WARMUP)
    fwd = _timed(lambda: mod.forward(db, is_train=False), RESNET_STEPS)
    ms = sorted(times)[len(times) // 2]
    fwd_ms = sorted(fwd)[len(fwd) // 2]
    peak = PEAK_FLOPS[dtype]
    res = dict(
        dtype=DTYPE_NAME[dtype], flags=flags, batch=RESNET_BATCH,
        step_ms_median=ms, step_ms_first5=warm, img_s=RESNET_BATCH / ms * 1e3,
        infer_ms_median=fwd_ms, infer_img_s=RESNET_BATCH / fwd_ms * 1e3,
        train_peak_share=RESNET_TRAIN_FLOPS * RESNET_BATCH / ms * 1e3 / peak,
        infer_peak_share=RESNET_FWD_FLOPS * RESNET_BATCH / fwd_ms * 1e3
        / peak, loss=loss, peak_mem_gb=peak_gb)
    log("ResNet-50 %s (%s) on %s, batch %d through CachedTrainStep: %d "
        "timed steps, ms/step median %.3f, first 5 (warm-up) %s, %.1f img/s, "
        "%.2f%% of the %g TFLOP/s peak at 24.6 GFLOP/img; inference median "
        "%.3f ms, %.1f img/s (%.2f%% of peak at 8.2 GFLOP/img); loss after "
        "%d steps %.4f; %s moved: %s; peak memory %.1f GB"
        % (DTYPE_NAME[dtype], flags, torch.cuda.get_device_name(0),
           RESNET_BATCH, RESNET_STEPS, ms, ["%.1f" % t for t in warm],
           res["img_s"], 100 * res["train_peak_share"], peak / 1e12, fwd_ms,
           res["infer_img_s"], 100 * res["infer_peak_share"],
           RESNET_WARMUP + RESNET_STEPS, loss, stat, moved, peak_gb))
    if not math.isfinite(loss):
        raise AssertionError("non-finite ResNet-50 loss (%s)" % dtype)
    if not moved:
        raise AssertionError("the BatchNorm moving statistics did not move")
    del mod, ex, db, prob
    torch.cuda.empty_cache()
    return res


def main():
    card = phase_device()
    phase_build()
    kern = phase_kernels()
    kern_bwd = phase_kernels_bwd()
    scale_kern = phase_scale_kernel()
    launches = {dt: phase_lm(dt) for dt in DTYPE_NAME}
    for dt, seed in itertools.product((torch.float32, torch.bfloat16),
                                      PARITY_SEEDS):
        phase_parity(dt, seed)
    phase_registration()
    scale_launches = phase_mlp()
    phase_mlp_parity()
    parity = phase_resnet_parity()
    resnet = [phase_resnet_train(dt) for dt in (torch.float32,
                                                torch.bfloat16)]
    lm_train, train_launches = {}, {}
    for dt in LM_TRAIN_DTYPES:
        lm_train[dt], train_launches[dt] = phase_lm_train(dt)
    train_parity = {dt: phase_lm_train_parity(dt)
                    for dt in LM_TRAIN_PARITY_TOL}
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.ops import scale as sc
    n_layers = GPT2_SMALL["n_layers"]
    entries = []
    for dt in DTYPE_NAME:
        bound_ms, bound_by = attention_bound_ms(MAIN_SHAPE, dt, True)
        entries.append({
            "name": "flash_attn_fwd[%s]" % DTYPE_NAME[dt],
            "route": "cuda",
            "design": kern[dt]["design"],
            "source": att.KERNEL_SOURCES[kern[dt]["design"]],
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:41",
            "launches": launches[dt] + train_launches[dt][0],
            "inference_launches": launches[dt],
            "train_launches": train_launches[dt][0],
            "train_launches_per_step": n_layers,
            "max_abs_err": kern[dt]["max_abs_err"],
            "max_row_rel_err": kern[dt]["max_row_rel"],
            "ms": kern[dt]["ms"],
            "strided_ms": kern[dt]["strided_ms"],
            "plain_ms": kern[dt]["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": kern[dt]["library_ms"],
            "shape": list(MAIN_SHAPE),
            "causal": True,
        })
    for dt in DTYPE_NAME:
        bound_ms, bound_by = attention_bwd_bound_ms(MAIN_SHAPE, dt, True)
        entries.append({
            "name": "flash_attn_bwd[%s]" % DTYPE_NAME[dt],
            "route": "cuda",
            "design": BWD_DESIGN_NOTE[kern_bwd[dt]["design"]],
            "source": att.BACKWARD_SOURCES[kern_bwd[dt]["design"]],
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:198",
            "launches": train_launches[dt][1],
            "train_launches_per_step": n_layers,
            "max_abs_err": kern_bwd[dt]["max_abs_err"],
            "max_row_rel_err": kern_bwd[dt]["max_row_rel"],
            "ms": kern_bwd[dt]["ms"],
            "strided_ms": kern_bwd[dt]["strided_ms"],
            "plain_ms": kern_bwd[dt]["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": kern_bwd[dt]["library_ms"],
            "shape": list(MAIN_SHAPE),
            "causal": True,
        })
    for dt in (torch.float32, torch.bfloat16):
        bound_ms, bound_by = scale_bound_ms(math.prod(SCALE_MAIN_SHAPE), dt)
        entries.append({
            "name": "scale[%s]" % DTYPE_NAME[dt],
            "route": "cuda",
            "design": "simt, one 16-byte vector a thread, blocks of 1024",
            "source": sc.KERNEL_SOURCE,
            "replaces": "tests/test_pallas_register.py:25",
            "launches": scale_launches[dt],
            "max_abs_err": scale_kern[dt]["max_abs_err"],
            "ms": scale_kern[dt]["ms"],
            "plain_ms": scale_kern[dt]["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": scale_kern[dt]["library_ms"],
            "shape": list(SCALE_MAIN_SHAPE),
        })
    log(card)
    print(json.dumps({"resnet50": {"card": card, "parity": parity,
                                   "train": resnet}}))
    print(json.dumps({"lm_train": {
        "card": card, "batch": LM_BATCH, "seq": LM_SEQ,
        "train": {DTYPE_NAME[dt]: r for dt, r in lm_train.items()},
        "parity": {DTYPE_NAME[dt]: r for dt, r in train_parity.items()}}}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
