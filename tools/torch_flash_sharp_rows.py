#!/usr/bin/env python3
"""Card check of the flash backward in sharp-softmax rows, against fp64.

At ``chip_smoke.py``'s sharp case, (2, 4, 200, D) causal with sm_scale 0.5,
one key takes nearly all of some queries' probability: ds = p (dp -
sum(p dp)) cancels, and those rows of dq are small against the terms they
sum.  ``chip_smoke.py`` holds such cases with
``mxnet_tpu_torch.test_utils.sharp_row_check``: each row of the kernel's
dq, dk, dv against an fp64 reference of the same formula, the error
taken against the size of the terms the row sums, at ``SHARP_ROW_C``
times the plain version's own error plus ``chip_smoke.BWD_ROW_RTOL``.
This tool draws ``--draws`` random inputs at D 128, 64, 32 and 16 in
fp32, bf16 and fp16 and prints, for each: the worst row-relative error
(``chip_smoke._grad_errors``, against the row's largest value) of the
kernel against the plain version (the measure the check used before)
and of each against fp64; the worst row error of each against fp64 in
the check's measure; the worst ratio of a kernel row's error to its
limit; how many draws fail the check (must be 0) and how many read over
``BWD_ROW_RTOL`` in the old measure.  Run from the repository root on the card:

    python3 tools/torch_flash_sharp_rows.py [--draws 20]

The last line is one JSON object with the numbers; the exit code is 1
when a draw fails the check.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch.ops import attention as att  # noqa: E402
from mxnet_tpu_torch.test_utils import (SHARP_ROW_C,  # noqa: E402
                                        attention_grads_fp64,
                                        sharp_row_check)

SCALE = 0.5


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_sharp_rows: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    with torch.no_grad():
        for d in (128, 64, 32, 16):
            shape = (2, 4, 200, d)
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                limit = cs.BWD_ROW_RTOL[dtype]
                worst = {"kernel-plain": [], "kernel-fp64-rowmax": [],
                         "plain-fp64-rowmax": [], "kernel-fp64": [],
                         "plain-fp64": [], "check": []}
                for draw in range(args.draws):
                    gen = torch.Generator(device="cuda").manual_seed(draw)
                    q, k, v, do = (cs._qkv(shape, dtype, gen)[0]
                                   for _ in range(4))
                    got = att.flash_attention_backward(q, k, v, do, True,
                                                       SCALE)
                    plain = att.chunked_attention_grads(q, k, v, do, True,
                                                        SCALE)
                    exact, terms = attention_grads_fp64(q, k, v, do, True,
                                                        SCALE)
                    check = sharp_row_check(got, plain, exact, terms, limit)
                    worst["kernel-plain"].append(
                        max(cs._grad_errors(got, plain)[1]))
                    # rounded once to fp32, so that the old measure's
                    # floor is fp32's smallest normal, as for the plain
                    # version
                    exact32 = [e.float() for e in exact]
                    worst["kernel-fp64-rowmax"].append(
                        max(cs._grad_errors(got, exact32)[1]))
                    worst["plain-fp64-rowmax"].append(
                        max(cs._grad_errors(plain, exact32)[1]))
                    worst["kernel-fp64"].append(check["kernel"])
                    worst["plain-fp64"].append(check["plain"])
                    worst["check"].append(check["worst"])
                row = dict(shape=list(shape), dtype=cs.DTYPE_NAME[dtype],
                           design=att.design_backward(dtype, d),
                           limit=limit, c=SHARP_ROW_C, draws=args.draws,
                           max_kernel_plain=max(worst["kernel-plain"]),
                           max_kernel_fp64_rowmax=max(
                               worst["kernel-fp64-rowmax"]),
                           max_plain_fp64_rowmax=max(
                               worst["plain-fp64-rowmax"]),
                           max_kernel_fp64=max(worst["kernel-fp64"]),
                           max_plain_fp64=max(worst["plain-fp64"]),
                           worst_of_limit=max(worst["check"]),
                           fail_check=sum(x > 1.0 for x in worst["check"]),
                           over_old_limit=sum(x > limit for x in
                                              worst["kernel-plain"]))
                rows.append(row)
                print(" ".join("%s=%s" % kv for kv in row.items()),
                      flush=True)
    print(json.dumps({"card": card, "rows": rows}))
    if any(r["fail_check"] for r in rows):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
