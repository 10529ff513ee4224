#!/usr/bin/env python3
"""Card timings of the flash-attention kernels at head dims 16 and 32.

Times the forward and backward kernels that ``attention.design`` picks at
D 16 and 32, causal, in fp32 (TF32 off), bf16 and fp16, at (8, 12, 1024,
32) (GPT-2 small's layer shape at D 32), the same at D 16, and the
Pythia-31M-width layer shape (8, 8, 2048, 32), beside their plain versions,
SDPA (forward, and its backward as ``torch.autograd.grad`` less its
forward) and their bounds (``chip_smoke.attention_bound_ms`` and
``attention_bwd_bound_ms``, computed from the shape).  Each number is the median of three rounds of
``chip_smoke.cuda_ms``.  Run from the root of a checkout on the card:

    python3 tools/torch_flash_small_d_timing.py [--repo PATH]

``--repo`` times the package of another checkout (one that has
``chip_smoke.py`` and ``mxnet_tpu_torch``), so that two trees can be
compared in one run on one card.  It prints the card's name and power
limit, one line per (shape, dtype) and as its last line one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

SHAPES = ((8, 12, 1024, 32), (8, 12, 1024, 16), (8, 8, 2048, 32))
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_small_d_timing: no CUDA card")
    sys.path.insert(0, os.path.abspath(args.repo))
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _build, attention as att
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    stems = sorted({os.path.splitext(os.path.basename(src))[0]
                    for dt in DTYPES for d in (16, 32)
                    for src in (att.KERNEL_SOURCES[att.design(dt, d)],
                                att.BACKWARD_SOURCES[
                                    att.design_backward(dt, d)])})
    _build.build_all(stems)
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for shape in SHAPES:
        for dtype in DTYPES:
            q, k, v, do = (cs._qkv(shape, dtype, gen)[0] for _ in range(4))
            fns = {
                "fwd_ms": lambda: att.flash_attention(q, k, v, True),
                "fwd_plain_ms": lambda: att.flash_attention_reference(
                    q, k, v, True),
                "fwd_sdpa_ms": lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True),
                "bwd_ms": lambda: att.flash_attention_backward(
                    q, k, v, do, True),
                "bwd_plain_ms": lambda: att.chunked_attention_grads(
                    q, k, v, do, True),
            }
            with torch.no_grad():
                rounds = [{n: cs.cuda_ms(fn, iters=10)
                           for n, fn in fns.items()} for _ in range(3)]
            with torch.enable_grad():
                sdpa_bwd = sorted(cs.sdpa_backward_ms(q, k, v, do)
                                  for _ in range(3))
            row = dict(shape=list(shape), dtype=cs.DTYPE_NAME[dtype],
                       design=att.design(dtype, shape[-1]),
                       **{n: sorted(r[n] for r in rounds)[1] for n in fns})
            row["bwd_sdpa_ms"] = sdpa_bwd[1]
            row["fwd_bound_ms"], row["fwd_bound_by"] = \
                cs.attention_bound_ms(shape, dtype, True)[:2]
            row["bwd_bound_ms"], row["bwd_bound_by"] = \
                cs.attention_bwd_bound_ms(shape, dtype, True)[:2]
            rows.append(row)
            print(" ".join("%s=%s" % (n, ("%.4f" % x if isinstance(x, float)
                                          else x)) for n, x in row.items()),
                  flush=True)
            del q, k, v, do
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "repo": os.path.abspath(args.repo),
                      "rows": rows}))


if __name__ == "__main__":
    main()
