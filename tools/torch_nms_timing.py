#!/usr/bin/env python3
"""The greedy-NMS kernels' time at phase 31a's three main cases of
``chip_smoke.py`` (SSD-300's head at ``nms_topk`` -1 and 400, Proposal's
pre-NMS 6,000), for the package under ``--root`` (default: this checkout),
on one CUDA card: CUDA events, the mean of 10 calls after 2, three
times, and each kernel's mean device ms over 5 calls under
``torch.profiler``.  It builds that checkout's ``nms.cu``, checks each
mask against the plain loop's once, and prints one JSON line.  To compare
two checkouts on one card, run it in turns in one command (A, B, B, A):

    python3 tools/torch_nms_timing.py [--root path/to/checkout]
"""
import argparse
import json
import os
import sys


def kernel_ms(fn, calls=5):
    """{kernel name: mean device ms a launch} over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us and "kernel" in e.key:
            out[e.key[:80]] = dev_us / 1e3 / max(e.count, 1)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import nms as nm
    card = cs.phase_device()
    build_s = _build.build_all(["nms"])["nms"]
    dev = torch.device("cuda", 0)
    rows = {}
    for c in cs.nms_cases(dev):
        if c["name"].startswith("ragged"):
            continue
        a = (c["boxes"], c["classes"], c["alive"], c["trip"], c["threshold"],
             c["force"])
        equal = bool(torch.equal(nm.nms(*a), nm.nms_reference(*a)))
        rows[c["name"]] = dict(
            equal_to_plain=equal,
            ms=[cs.cuda_ms(lambda: nm.nms(*a), iters=cs.NMS_TIMING_ITERS,
                           warmup=2) for _ in range(3)],
            kernel_ms=kernel_ms(lambda: nm.nms(*a)))
    print(json.dumps({"nms_timing": {"root": root, "card": card,
                                     "build_s": build_s, "rows": rows}}),
          flush=True)
    if not all(r["equal_to_plain"] for r in rows.values()):
        raise SystemExit("a mask differs from the plain loop's")


if __name__ == "__main__":
    main()
