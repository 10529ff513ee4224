#!/usr/bin/env python3
"""Quick card check of the flash-attention kernels.

Builds the attention kernels, then runs ``chip_smoke.py``'s phase-3 cases
(``FLASH_CASES``, contiguous and as einsum-style strided views) in the
dtypes asked for: the forward against ``flash_attention_reference``
(``ATOL``, ``ROW_RTOL``), the backward against ``chunked_attention_grads``
(``BWD_ATOL``, ``BWD_ROW_RTOL``) and against a second call, bit for bit.
Unlike phase 3 it goes on past a failing case, and prints each case's
forward before its backward runs, so one run shows every case up to a
kernel that faults.  It takes about half a minute on an H100; run from
the repository root:

    python3 tools/torch_flash_check.py [--dtypes fp32,bf16,fp16] [--dims 16,32]

It prints each kernel's registers and spills, one line per case, and as
its last line one JSON object; it exits non-zero if a case fails.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch.ops import _build, attention as att  # noqa: E402

STEMS = tuple(sorted({os.path.splitext(os.path.basename(src))[0]
                     for src in list(att.KERNEL_SOURCES.values())
                     + list(att.BACKWARD_SOURCES.values())}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtypes", default="fp32,bf16,fp16")
    ap.add_argument("--dims", type=lambda x: [int(d) for d in x.split(",")],
                    help="only the cases at these head dims")
    args = ap.parse_args()
    names = {n: dt for dt, n in cs.DTYPE_NAME.items()}
    dtypes = [names[n] for n in args.dtypes.split(",")]
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_check: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(list(STEMS))
    for stem in STEMS:
        print("ptxas (%s):\n%s"
              % (stem, cs.ptxas_summary(_build.build_info(stem)["log"])))
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, bad = [], 0
    flash_cases = [c for c in cs.FLASH_CASES
                   if args.dims is None or c[0][-1] in args.dims]
    for dt, (shape, causal, scale), strided in itertools.product(
            dtypes, flash_cases, (False, True)):
        q, k, v = cs._qkv(shape, dt, gen, strided)
        do = cs._qkv(shape, dt, gen, strided)[0]
        case = dict(dtype=cs.DTYPE_NAME[dt], shape=shape, causal=causal,
                    scale=scale, strided=strided,
                    design=att.design(dt, shape[-1]))
        # the forward's line is printed before the backward runs, so a
        # backward that faults still leaves the forward's result
        out = att.flash_attention(q, k, v, causal, scale)
        ref = att.flash_attention_reference(q, k, v, causal, scale)
        diff = (out.float() - ref.float()).abs()
        case["fwd_err"] = diff.max().item()
        case["fwd_row_rel"] = (diff.amax(-1) / ref.float().abs().amax(-1)
                               .clamp_min(1e-30)).max().item()
        fwd_ok = (bool(torch.isfinite(out).all())
                  and case["fwd_err"] <= cs.ATOL[dt]
                  and case["fwd_row_rel"] <= cs.ROW_RTOL[dt])
        print("fwd " + " ".join("%s=%s" % kv for kv in case.items())
              + " ok=%s" % fwd_ok, flush=True)
        got = att.flash_attention_backward(q, k, v, do, causal, scale)
        again = att.flash_attention_backward(q, k, v, do, causal, scale)
        case["repeat_equal"] = all(torch.equal(a, b)
                                   for a, b in zip(got, again))
        case["bwd_err"], brels = cs._grad_errors(
            got, att.chunked_attention_grads(q, k, v, do, causal, scale))
        case["bwd_row_rel"] = max(brels)
        bwd_ok = (all(bool(torch.isfinite(g).all()) for g in got)
                  and case["bwd_err"] <= cs.BWD_ATOL.get(dt, float("inf"))
                  and case["bwd_row_rel"] <= cs.BWD_ROW_RTOL[dt]
                  and case["repeat_equal"])
        case["ok"] = fwd_ok and bwd_ok
        bad += not case["ok"]
        cases.append(case)
        print("bwd " + " ".join("%s=%s" % kv for kv in case.items()),
              flush=True)
        del q, k, v, do, out, ref, got, again
    print(json.dumps({"failed": bad, "cases": cases}))
    if bad:
        raise SystemExit("%d cases failed" % bad)

if __name__ == "__main__":
    main()
