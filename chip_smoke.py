#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mxnet_tpu_torch``) on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA H100 and
``nvcc``:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: require CUDA; print the card's name and power limit.
2. build: compile every CUDA kernel of the path from ``ops/csrc`` with nvcc.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the parity-test shapes, ragged lengths, ``sm_scale=0.5``, D in
   {16, 32, 64, 128} and the full-width layer shape (8, 12, 1024, 64) causal,
   in fp32 (TF32 off), bf16 and fp16; timings of the kernel, the plain
   version and ``F.scaled_dot_product_attention`` (a yardstick only: the
   port never calls it) at the full-width shape.
4. LM inference at GPT-2 small widths (12 layers, d_model 768, 12 heads,
   d_ff 3072, vocab 50257, max_len 1024; seeded random weights): 4 batches
   of 8 x 1024 tokens scored to logits and mean next-token NLL, in fp32 and
   bf16, with the kernel's launch count read around each run.
5. parity: a small LM's logits and NLL on the card (through the kernel)
   against the same params on the CPU (through the plain version).

It prints one ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Without a card, or without the rest
of the repository beside it, it exits non-zero before printing either.
"""
from __future__ import annotations

import json
import math
import subprocess
import time

import torch

# atol per dtype.  fp32: the kernel and the plain version both sum
# in fp32, in other orders, over at most 1024 keys.  bf16/fp16: both round
# the same fp32 value to the output type, so they differ by at most about
# one unit in the last place of outputs of magnitude below 4.
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 4e-3}
DTYPE_NAME = {torch.float32: "fp32", torch.bfloat16: "bf16",
              torch.float16: "fp16"}
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, and
# FLOP/s per input type (fp32 outside the tensor cores)
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.float16: 989e12}
MAIN_SHAPE = (8, 12, 1024, 64)
GPT2_SMALL = dict(vocab=50257, d_model=768, n_heads=12, d_ff=3072,
                  n_layers=12, max_len=1024)
LM_BATCH, LM_SEQ, LM_REQUESTS = 8, 1024, 4


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


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    seconds = _build.build_all(["flash_attn_fwd"])
    log("build: %s in %.1f s wall" % (seconds, time.perf_counter() - t0))
    for stem in seconds:
        log("ptxas (%s):\n%s" % (stem, _build.build_info(stem)["log"].strip()))


def _qkv(shape, dtype, gen):
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(3)]


def phase_kernels():
    """Kernel against plain version at every case; timings at MAIN_SHAPE.
    Returns {dtype: {"max_abs_err", "ms", "plain_ms", "library_ms"}}."""
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.ops import attention as att
    cases = [  # (shape, causal, sm_scale)
        ((2, 3, 64, 16), False, None), ((2, 3, 64, 16), True, None),
        ((1, 2, 48, 16), True, None), ((1, 2, 48, 16), False, None),
        ((1, 1, 16, 16), False, 0.5), ((2, 2, 77, 32), True, None),
        ((2, 4, 200, 64), False, None), ((2, 4, 200, 64), True, 0.5),
        ((1, 3, 130, 128), True, None), ((1, 3, 130, 128), False, None),
        ((1, 1, 1, 64), True, None), (MAIN_SHAPE, True, None),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            worst = 0.0
            for shape, causal, scale in cases:
                q, k, v = _qkv(shape, dtype, gen)
                out = att.flash_attention(q, k, v, causal, scale)
                ref = att.flash_attention_reference(q, k, v, causal, scale)
                torch.cuda.synchronize()
                if out.dtype != dtype or out.shape != q.shape:
                    raise AssertionError("kernel output %s %s at %s"
                                         % (out.dtype, tuple(out.shape), shape))
                if not torch.isfinite(out).all():
                    raise AssertionError("non-finite kernel output at %s %s"
                                         % (shape, dtype))
                err = (out.float() - ref.float()).abs().max().item()
                worst = max(worst, err)
                log("  %s %-18s causal=%-5s scale=%-4s max|err| %.3g"
                    % (DTYPE_NAME[dtype], shape, causal, scale, err))
                if err > ATOL[dtype]:
                    raise AssertionError(
                        "kernel disagrees with plain version at %s %s causal=%s"
                        " scale=%s: %.3g > atol %g"
                        % (shape, dtype, causal, scale, err, ATOL[dtype]))
            q, k, v = _qkv(MAIN_SHAPE, dtype, gen)
            timings = {
                "ms": cuda_ms(lambda: att.flash_attention(q, k, v, True)),
                "plain_ms": cuda_ms(
                    lambda: att.flash_attention_reference(q, k, v, True)),
                "library_ms": cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=True)),
            }
            results[dtype] = dict(max_abs_err=worst, **timings)
            log("%s at %s causal: kernel %.4f ms, plain %.4f ms, SDPA %.4f ms,"
                " worst max|err| %.3g (atol %g)"
                % (DTYPE_NAME[dtype], MAIN_SHAPE, timings["ms"],
                   timings["plain_ms"], timings["library_ms"], worst,
                   ATOL[dtype]))
        # the wrapper refuses what the kernel does not take
        q, k, v = _qkv((1, 2, 64, 64), torch.float32, gen)
        for bad in (lambda: att.flash_attention(q.transpose(1, 2), k, v),
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


def phase_parity():
    """Small LM on the card (kernel) against the CPU (plain version), fp32."""
    from mxnet_tpu_torch.models import transformer as tr
    cfg = tr.TransformerLMConfig(vocab=512, d_model=128, n_heads=2, d_ff=256,
                                 n_layers=2, max_len=256)
    gen = torch.Generator().manual_seed(1)
    cpu_params = tr.init_transformer_params(gen, cfg, device="cpu")
    cuda_params = {n: t.to("cuda") for n, t in cpu_params.items()}
    seq = torch.randint(0, cfg.vocab, (2, 201), generator=gen)
    tokens, labels = seq[:, :-1], seq[:, 1:]
    with torch.inference_mode():
        ref = tr.transformer_forward(cpu_params, tokens, cfg)
        out = tr.transformer_forward(cuda_params, tokens.cuda(), cfg).cpu()
        nll_ref = tr.nll_from_logits(ref, labels).item()
        nll_out = tr.nll_from_logits(out, labels).item()
    err = (out - ref).abs().max().item()
    log("parity (fp32, S=200): logits max|err| %.3g, NLL cuda %.6f cpu %.6f"
        % (err, nll_out, nll_ref))
    # fp32 sums over d_model/d_ff in cuBLAS's order against the CPU's
    if err > 1e-3 or abs(nll_out - nll_ref) > 1e-4:
        raise AssertionError("LM on the card disagrees with the CPU")


def main():
    card = phase_device()
    phase_build()
    kern = phase_kernels()
    launches = {dt: phase_lm(dt) for dt in (torch.float32, torch.bfloat16)}
    phase_parity()
    from mxnet_tpu_torch.ops import attention as att
    entries = []
    for dt in (torch.float32, torch.bfloat16):
        bound_ms, bound_by = attention_bound_ms(MAIN_SHAPE, dt, True)
        entries.append({
            "name": "flash_attn_fwd[%s]" % DTYPE_NAME[dt],
            "route": "cuda",
            "source": att.KERNEL_SOURCE,
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:41",
            "launches": launches[dt],
            "max_abs_err": kern[dt]["max_abs_err"],
            "ms": kern[dt]["ms"],
            "plain_ms": kern[dt]["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": kern[dt]["library_ms"],
            "shape": list(MAIN_SHAPE),
            "causal": True,
        })
    log(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
