#!/usr/bin/env python3
"""Card check of the flash backward in sharp-softmax rows, against fp64.

At ``chip_smoke.py``'s sharp case, (2, 4, 200, D) causal with sm_scale 0.5,
one key takes nearly all of some queries' probability: ds = p (dp -
sum(p dp)) cancels, and those rows of dq are small against the terms they
sum.  ``chip_smoke.BWD_ROW_RTOL`` holds the kernel against the plain fp32
backward (``chunked_attention_grads``) row by row, so in such rows it
compares two fp32 summation orders of a cancelling sum.  This tool draws
``--draws`` random inputs at D 64, 32 and 16 and prints, for each dtype,
the worst row-relative error (``chip_smoke._grad_errors``) over dq, dk,
dv of: the kernel against the plain version (the check's measure), the
kernel against an fp64 reference of the same formula, and the plain
fp32 version against that fp64 reference; and how many draws read over
the limit.  Where the kernel lies as close to fp64 as the plain version
does, an over-limit reading is the plain version's error, not the
kernel's.  Run from the repository root on the card:

    python3 tools/torch_flash_sharp_rows.py [--draws 20]

The last line is one JSON object with the numbers.
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

SCALE = 0.5


def grads_fp64(q, k, v, do, causal, scale):
    """dq, dk, dv of softmax attention in fp64, the plain backward's
    formula (masked scores -1e30, ds zeroed where masked)."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    s = q @ k.transpose(-1, -2) * scale
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
    return ds @ k * scale, ds.transpose(-1, -2) @ q * scale, dv


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
        for d in (64, 32, 16):
            shape = (2, 4, 200, d)
            for dtype in (torch.float32, torch.bfloat16):
                limit = cs.BWD_ROW_RTOL[dtype]
                worst = {"kernel-plain": [], "kernel-fp64": [],
                         "plain-fp64": []}
                for draw in range(args.draws):
                    gen = torch.Generator(device="cuda").manual_seed(draw)
                    q, k, v, do = (cs._qkv(shape, dtype, gen)[0]
                                   for _ in range(4))
                    got = att.flash_attention_backward(q, k, v, do, True,
                                                       SCALE)
                    plain = att.chunked_attention_grads(q, k, v, do, True,
                                                        SCALE)
                    # rounded once to fp32, so the row measure's floor is
                    # fp32's smallest normal, as for the plain version
                    exact = [g.float() for g in grads_fp64(q, k, v, do, True,
                                                           SCALE)]
                    for name, (a, b) in (("kernel-plain", (got, plain)),
                                         ("kernel-fp64", (got, exact)),
                                         ("plain-fp64", (plain, exact))):
                        worst[name].append(max(cs._grad_errors(a, b)[1]))
                row = dict(shape=list(shape), dtype=cs.DTYPE_NAME[dtype],
                           design=att.design_backward(dtype, d),
                           limit=limit, draws=args.draws,
                           **{"max_" + n: max(w) for n, w in worst.items()},
                           **{"over_" + n: sum(x > limit for x in w)
                              for n, w in worst.items()})
                rows.append(row)
                print(" ".join("%s=%s" % kv for kv in row.items()),
                      flush=True)
    print(json.dumps({"card": card, "rows": rows}))


if __name__ == "__main__":
    main()
