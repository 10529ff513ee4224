#!/usr/bin/env python3
"""``csr_dot``'s time at phase 32b's shape of ``chip_smoke.py`` (8192 x
1,000,001, up to 16 Zipf ids a row, N 2) and at the FM's (64 x 200, 12
ids a row, N 1 and 8), for the package under ``--root`` (default: this
checkout), on one CUDA card: CUDA events, the mean of 200 calls after 10,
three times, and the kernel's mean device ms over 20 calls under
``torch.profiler``.  It builds that checkout's ``csr_dot.cu``, checks
each output bit for bit against the plain version on the CPU once, and
prints one JSON line.  To compare two checkouts on one card, run it in
turns in one command (A, B, B, A):

    python3 tools/torch_csr_dot_timing.py [--root path/to/checkout]
"""
import argparse
import json
import os
import sys


def kernel_ms(fn, calls=20):
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
        if dev_us and "csr_dot" in e.key:
            out[e.key[:80]] = dev_us / 1e3 / max(e.count, 1)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import sparse_dot as sd
    card = cs.phase_device()
    build_s = _build.build_all(["csr_dot"])["csr_dot"]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(33)
    path = cs.csr_on(cs.path_csr_parts(np.random.RandomState(33)),
                     cs.SPARSE_BATCH, cs.SPARSE_DIM, torch.float32, dev, gen)
    fm = cs.csr_on(cs._csr_case_parts(np.random.RandomState(34), 64, 200,
                                      [12] * 64), 64, 200, torch.float32,
                   dev, gen)
    rows = {}
    for name, csr, n in (("path N 2", path, 2), ("fm N 1", fm, 1),
                         ("fm N 8", fm, 8)):
        b = torch.randn((csr.shape[1], n), generator=gen, device=dev)
        plain = sd.csr_dot_reference(csr.to("cpu"), b.cpu())
        rows[name] = dict(
            shape=[csr.shape[0], csr.shape[1], n], nnz=int(csr.indptr[-1]),
            equal_to_plain=bool(torch.equal(sd.csr_dot(csr, b).cpu(),
                                            plain)),
            ms=[cs.cuda_ms(lambda: sd.csr_dot(csr, b), iters=200, warmup=10)
                for _ in range(3)],
            kernel_ms=kernel_ms(lambda: sd.csr_dot(csr, b)))
    print(json.dumps({"csr_dot_timing": {"root": root, "card": card,
                                         "build_s": build_s, "rows": rows}}),
          flush=True)
    if not all(r["equal_to_plain"] for r in rows.values()):
        raise SystemExit("csr_dot differs from the plain version")


if __name__ == "__main__":
    main()
