#!/usr/bin/env python3
"""Where the time of one ResNet-50 training step goes on a CUDA card.

Builds ``chip_smoke.py``'s ResNet-50 Module (``bench.py``'s training
configuration: batch 32, 3 x 224 x 224, SGD with momentum, through
``Module._fit_step`` and ``CachedTrainStep``), in fp32 (TF32 off) and
bf16.  For each it runs 5 warm-up steps, then profiles 10 steps with
``torch.profiler`` and prints the device time per step by group:

- by phase of the step: forward (the graph walk), backward (autograd)
  and update (the multi-tensor SGD); the input batch's copy and the
  moving statistics' write-back count in "other";
- by operation: the forward kernels by the registry op that launched
  them (the tool wraps every op in a ``record_function`` while it
  profiles); the backward kernels by the autograd node that launched
  them, gathered into convolution, pooling, ReLU, the FC layer, the
  softmax and "BatchNorm and the rest" (the elementwise and reduction
  nodes of BatchNorm's formula, and the residual adds);
- the device operations per step, the device's busy share of the wall
  time, and the top kernels by name.

Then, with the profiler off, it times 3 runs of 10 steps and prints each
run's median ms/step.  Run from the repository root on the card:

    python3 tools/torch_resnet_breakdown.py

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
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.module import cached_step  # noqa: E402
from mxnet_tpu_torch.ops import registry  # noqa: E402

WARMUP, STEPS, RUNS = 5, 10, 3
BACKWARD_GROUPS = (("Convolution", "conv"), ("Pool", "pool"),
                   ("Maximum", "relu"), ("Mm", "fc"), ("Addmm", "fc"),
                   ("SemanticGrad", "softmax"))


@contextlib.contextmanager
def annotated():
    """Name every registry op's forward, and the step's phases, for the
    profiler; undone on exit."""
    saved_fns = {op: op.fn for op in set(registry.OP_REGISTRY.values())}
    saved = (cached_step._run_graph, mt.optimizer.SGD.fused_update)

    def wrap(name, fn):
        def inner(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return inner
    for op, fn in saved_fns.items():
        op.fn = wrap("op:" + op.name, fn)
    cached_step._run_graph = wrap("phase:forward", saved[0])
    mt.optimizer.SGD.fused_update = wrap("phase:update", saved[1])
    try:
        yield
    finally:
        for op, fn in saved_fns.items():
            op.fn = fn
        cached_step._run_graph = saved[0]
        mt.optimizer.SGD.fused_update = saved[1]


def _ranges(events, prefixes):
    """{thread: (starts, [(start, end, name)])} of the CPU ranges whose
    name starts with one of ``prefixes``."""
    by_thread = {}
    for e in events:
        if e.name.startswith(prefixes):
            by_thread.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end, e.name))
    return {t: ([r[0] for r in sorted(rs)], sorted(rs))
            for t, rs in by_thread.items()}


def _innermost(ranges, thread, t):
    """The name of the innermost range on ``thread`` that holds time t."""
    starts, rs = ranges.get(thread, ([], []))
    i = bisect.bisect_right(starts, t) - 1
    best = None
    while i >= 0:
        start, end, name = rs[i]
        if end >= t and (best is None or start >= best[0]):
            best = (start, name)
            break
        i -= 1
    return best[1] if best else None


def _group(phase, label):
    if phase == "forward":
        return "fwd " + (label[3:] if label else "?")
    if phase == "backward":
        node = label.split(": ")[-1] if label else "?"
        for key, group in BACKWARD_GROUPS:
            if key in node:
                return "bwd " + group
        return "bwd BatchNorm and the rest"
    return phase


def profile_steps(dtype):
    gpu = mt.gpu(0)
    flags = cs.tf32_flags() if dtype == torch.float32 else "bf16"
    mod = cs.resnet_module(gpu, cs.RESNET_BATCH, dtype)
    cs.resnet_train_setup(mod)
    db = cs.resnet_batch(gpu, cs.RESNET_BATCH, dtype)
    for _ in range(WARMUP):
        mod._fit_step(db)
    torch.cuda.synchronize()
    with annotated(), profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            mod._fit_step(db)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    if mod._cached_step is None:
        raise SystemExit("the step did not take CachedTrainStep")
    events = prof.events()
    phases = _ranges(events, ("phase:",))
    ops = _ranges(events, ("op:", "autograd::engine::evaluate_function"))
    groups, kernels, launches = {}, {}, 0
    for e in events:
        for k in getattr(e, "kernels", ()):
            ms = k.duration / 1e3 / STEPS
            phase = _innermost(phases, e.thread, e.time_range.start)
            phase = phase[6:] if phase else None
            label = _innermost(ops, e.thread, e.time_range.start)
            if phase is None:
                phase = "backward" if label and label.startswith(
                    "autograd") else "other"
            g = _group(phase, label)
            groups[g] = groups.get(g, 0.0) + ms
            kk = kernels.setdefault(k.name, [0.0, 0])
            kk[0] += ms
            kk[1] += 1 / STEPS
            launches += 1
    device_ms = sum(groups.values())
    if device_ms == 0:
        raise SystemExit("torch.profiler recorded no device time")
    launches /= STEPS
    print("ResNet-50 %s (%s), batch %d: wall %.3f ms/step (profiler on), "
          "device %.3f ms, busy %.1f%%, %.1f device ops per step"
          % (cs.DTYPE_NAME[dtype], flags, cs.RESNET_BATCH, wall_ms,
             device_ms, 100 * device_ms / wall_ms, launches))
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("  %-30s %9.4f ms  %5.1f%%" % (name, ms, 100 * ms / device_ms))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, count) in top:
        print("    %8.4f ms  x%-6.1f %s" % (ms, count, name[:110]))
    medians = []
    for _ in range(RUNS):
        times = cs._timed(lambda: mod._fit_step(db), STEPS)
        medians.append(sorted(times)[len(times) // 2])
    print("profiler off: median ms/step of %d runs of %d steps: %s"
          % (RUNS, STEPS, ["%.3f" % m for m in medians]))
    del mod, db
    torch.cuda.empty_cache()
    return {"dtype": cs.DTYPE_NAME[dtype], "flags": flags,
            "batch": cs.RESNET_BATCH, "steps": STEPS,
            "step_ms_medians": medians, "wall_ms": wall_ms,
            "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "device_ops_per_step": launches, "groups_ms": groups,
            "top": [[name[:80], ms, count] for name, (ms, count) in top]}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_resnet_breakdown: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card)
    runs = [profile_steps(dt) for dt in (torch.float32, torch.bfloat16)]
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()
