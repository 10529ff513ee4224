#!/usr/bin/env python3
"""Where the time of one MNIST-MLP training step goes on a CUDA card.

Binds the MLP that ``chip_smoke.py`` trains (784-128-64-10 with the
registered ``pl_scale`` kernel after the first activation, batch 64,
fp32, SGD with momentum), runs 5 warm-up steps, then profiles 20 steps
(forward, backward and the six updates, nothing else) with
``torch.profiler`` and prints the device time per step by kernel,
grouped into the scale kernel, matrix products and the rest, the kernels
launched per step, and the device's busy share of the wall time.  Then,
with the profiler off, it times 5 runs of the same 20 steps and prints
each run's median ms/step, so that the host clock's spread between runs
shows beside the figure.  Run from the repository root on the card:

    python3 tools/torch_mlp_breakdown.py

The last line is one JSON object with the numbers.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402

WARMUP, STEPS, RUNS = 5, 20, 5


def _group(name):
    low = name.lower()
    if "scale_kernel" in low:
        return "scale"
    if any(w in low for w in ("gemm", "cutlass", "sm90_xmma", "nvjet")):
        return "matmul"
    return "other"


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_mlp_breakdown: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.register_pl_scale()
    gpu = mt.gpu(0)
    x, y, _, _ = cs._mnist_on(gpu)
    exe = cs.bind_mlp(gpu)
    cs.init_mlp(exe)
    cs.train_mlp(exe, x, y, WARMUP)
    x, y = x[WARMUP * cs.MLP_BATCH:], y[WARMUP * cs.MLP_BATCH:]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cs.train_mlp(exe, x, y, STEPS)
        wall_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        k = kernels.setdefault(evt.key, [0.0, 0])
        k[0] += us / 1e3 / STEPS
        k[1] += evt.count / STEPS
    device_ms = sum(ms for ms, _ in kernels.values())
    if device_ms == 0:
        raise SystemExit("torch.profiler recorded no device time")
    launches = sum(n for _, n in kernels.values())
    groups = {}
    for name, (ms, _) in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    print("fp32 MLP step, batch %d: wall %.3f ms/step (profiler on), device "
          "%.4f ms, busy %.1f%%, %.1f device ops per step"
          % (cs.MLP_BATCH, wall_ms, device_ms, 100 * device_ms / wall_ms,
             launches))
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("  %-8s %8.4f ms  %5.1f%%" % (name, ms, 100 * ms / device_ms))
    for name, (ms, count) in top:
        print("    %8.4f ms  x%-5.1f %s" % (ms, count, name[:100]))
    medians = []
    for _ in range(RUNS):
        _, times = cs.train_mlp(exe, x, y, STEPS)
        medians.append(1e3 * sorted(times)[len(times) // 2])
    print("profiler off: median ms/step of %d runs of %d steps: %s"
          % (RUNS, STEPS, ["%.3f" % m for m in medians]))
    print(json.dumps({"card": card, "batch": cs.MLP_BATCH, "steps": STEPS,
                      "step_ms_medians": medians,
                      "wall_ms": wall_ms, "device_ms": device_ms,
                      "busy_share": device_ms / wall_ms,
                      "device_ops_per_step": launches, "groups_ms": groups,
                      "top": [[name[:80], ms, count]
                              for name, (ms, count) in top]}))


if __name__ == "__main__":
    main()
