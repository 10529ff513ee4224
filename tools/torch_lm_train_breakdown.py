#!/usr/bin/env python3
"""Where the time of one LM training step goes on a CUDA card.

Runs the PyTorch port's transformer LM at GPT-2 small widths (12 layers,
d_model 768, 12 heads, d_ff 3072, vocab 50257; seeded random weights)
through ``make_train_step`` (SGD, lr 0.1) on one batch of 8 x 1024 tokens,
in fp32 (TF32 off), bf16 and fp16: 3 warm-up steps, then 3 steps under
``torch.profiler``.  It prints the device time per step by group:

- flash forward and flash backward: the hand-written kernels, by name;
- products: cuBLAS's GEMM kernels, forward and backward;
- log-softmax/NLL and its gradient: every kernel launched inside
  ``nll_from_logits`` (the fp32 cast of the logits, ``log_softmax``, the
  gather and the mean) and by the autograd nodes of that piece, which the
  tool brackets with two identity nodes while it profiles;
- the update: the ``torch._foreach_*`` calls of the step;
- the rest (embeddings, RMSNorm, GELU, adds, dtype casts and their
  gradients);

with the device operations per step, the device's busy share of the wall
time and the top kernels by name.  Then, with the profiler off, it times
3 runs of 5 steps and prints each run's median ms/step.  Run from the
repository root on the card:

    python3 tools/torch_lm_train_breakdown.py

The last line is one JSON object with the numbers.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mxnet_tpu_torch.models import transformer as tr  # noqa: E402

GPT2_SMALL = dict(vocab=50257, d_model=768, n_heads=12, d_ff=3072,
                  n_layers=12, max_len=1024)
BATCH, SEQ, LR = 8, 1024, 0.1
WARMUP, STEPS, RUNS, RUN_STEPS = 3, 3, 3, 5
UPDATE_OPS = ("_foreach_sub_", "_foreach_mul", "_foreach_mul_",
              "_foreach_add_")


class _Mark(torch.autograd.Function):
    """Identity whose backward opens (``opening``) or closes a profiler
    range on the autograd thread: put on the loss and on the logits, it
    brackets the backward of everything between them."""

    @staticmethod
    def forward(ctx, x, ranges, opening):
        ctx.ranges, ctx.opening = ranges, opening
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.opening:
            ctx.ranges.append(record_function("phase:loss"))
            ctx.ranges[-1].__enter__()
        elif ctx.ranges:
            ctx.ranges.pop().__exit__(None, None, None)
        return g, None, None


@contextlib.contextmanager
def annotated():
    """Mark the loss (forward and backward) and the update for the
    profiler; undone on exit."""
    saved_nll = tr.nll_from_logits
    saved_ops = {n: getattr(torch, n) for n in UPDATE_OPS}

    def nll(logits, labels):
        ranges = []
        with record_function("phase:loss"):
            loss = saved_nll(_Mark.apply(logits, ranges, False), labels)
            return _Mark.apply(loss, ranges, True)

    def wrap(fn):
        def inner(*args, **kwargs):
            with record_function("phase:update"):
                return fn(*args, **kwargs)
        return inner
    tr.nll_from_logits = nll
    for n, fn in saved_ops.items():
        setattr(torch, n, wrap(fn))
    try:
        yield
    finally:
        tr.nll_from_logits = saved_nll
        for n, fn in saved_ops.items():
            setattr(torch, n, fn)


def _ranges(events):
    """{thread: (starts, [(start, end, name)])} of the phase ranges, from
    the profiler's Kineto events (times in ns)."""
    by_thread = {}
    for k in events:
        if k.device_type() == DeviceType.CPU and k.name().startswith(
                "phase:"):
            by_thread.setdefault(k.start_thread_id(), []).append(
                (k.start_ns(), k.end_ns(), k.name()[6:]))
    return {t: ([r[0] for r in sorted(rs)], sorted(rs))
            for t, rs in by_thread.items()}


def _phase(ranges, thread, t):
    starts, rs = ranges.get(thread, ([], []))
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        start, end, name = rs[i]
        if end >= t:
            return name
        i -= 1
    return None


def _group(kernel, phase):
    low = kernel.lower()
    if "flash_attn_fwd" in low:
        return "flash fwd"
    if "flash_attn_bwd" in low:
        return "flash bwd"
    if phase == "update":
        return "update"
    if phase == "loss":
        return "log-softmax/NLL and its gradient"
    if any(w in low for w in ("gemm", "cutlass", "xmma", "nvjet")):
        return "products"
    return "rest"


def breakdown(dtype):
    flags = "TF32 off" if dtype == torch.float32 else str(dtype)[6:]
    cfg = tr.TransformerLMConfig(dtype=dtype, **GPT2_SMALL)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tr.init_transformer_params(gen, cfg)
    seq = torch.randint(0, cfg.vocab, (BATCH, SEQ + 1), generator=gen,
                        device="cuda")
    tokens, labels = tr.place_batch(seq[:, :-1], seq[:, 1:])
    step = tr.make_train_step(cfg, lr=LR)
    for _ in range(WARMUP):
        step(params, tokens, labels)
    torch.cuda.synchronize()
    with annotated(), profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(params, tokens, labels)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    # each device operation once, from the profiler's Kineto events (a
    # FunctionEvent's ``kernels`` may repeat one that another event with
    # the same correlation id also lists); its phase is that of the CPU op
    # that launched it, found by correlation id
    events = prof.profiler.kineto_results.events()
    ranges = _ranges(events)
    launchers = {}
    for k in events:
        if k.device_type() == DeviceType.CPU \
                and k.linked_correlation_id() == 0:
            launchers.setdefault(k.correlation_id(), []).append(k)
    groups, kernels, launches = {}, {}, 0
    for k in events:
        # the device's copies of the phase ranges are annotations, not work
        if k.device_type() != DeviceType.CUDA \
                or k.name().startswith("phase:"):
            continue
        ms = k.duration_ns() / 1e6 / STEPS
        cpu = max(launchers.get(k.linked_correlation_id(), ()),
                  default=None, key=lambda c: c.start_ns())
        phase = _phase(ranges, cpu.start_thread_id(), cpu.start_ns()) \
            if cpu is not None else None
        g = _group(k.name(), phase)
        groups[g] = groups.get(g, 0.0) + ms
        kk = kernels.setdefault(k.name(), [0.0, 0])
        kk[0] += ms
        kk[1] += 1 / STEPS
        launches += 1
    device_ms = sum(groups.values())
    if device_ms == 0:
        raise SystemExit("torch.profiler recorded no device time")
    launches /= STEPS
    print("\nLM train %s (%s), batch %dx%d: wall %.3f ms/step (profiler on), "
          "device %.3f ms, busy %.1f%%, %.1f device ops per step"
          % (str(dtype)[6:], flags, BATCH, SEQ, wall_ms, device_ms,
             100 * device_ms / wall_ms, launches))
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("  %-34s %9.3f ms  %5.1f%%" % (name, ms, 100 * ms / device_ms))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, count) in top:
        print("    %8.3f ms  x%-6.1f %s" % (ms, count, name[:110]))
    medians = []
    for _ in range(RUNS):
        times = []
        for _ in range(RUN_STEPS):
            t0 = time.perf_counter()
            step(params, tokens, labels)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        medians.append(sorted(times)[len(times) // 2])
    print("profiler off: median ms/step of %d runs of %d steps: %s"
          % (RUNS, RUN_STEPS, ["%.3f" % m for m in medians]))
    del params, step
    torch.cuda.empty_cache()
    return {"dtype": str(dtype)[6:], "flags": flags, "batch": BATCH,
            "seq": SEQ, "steps": STEPS, "step_ms_medians": medians,
            "wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "device_ops_per_step": launches, "groups_ms": groups,
            "top": [[name[:80], ms, count] for name, (ms, count) in top]}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_lm_train_breakdown: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = [breakdown(dt) for dt in (torch.float32, torch.bfloat16,
                                     torch.float16)]
    print(json.dumps({"card": card, "breakdown": rows}))


if __name__ == "__main__":
    main()
