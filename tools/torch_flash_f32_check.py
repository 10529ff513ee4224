#!/usr/bin/env python3
"""Quick card check of the fp32 flash-attention kernels.

Builds the attention kernels, then runs ``chip_smoke.py``'s phase-3 cases
(``FLASH_CASES``, contiguous and as einsum-style strided views) in fp32
only: the forward against ``flash_attention_reference`` (``ATOL``,
``ROW_RTOL``), the backward against ``chunked_attention_grads``
(``BWD_ATOL``, ``BWD_ROW_RTOL``) and against a second call, bit for bit.
At D 64 and 128 these take the tensor-core kernels
(``flash_attn_{fwd,bwd}_f32_sm90.cu``), at D 16 and 32 the SIMT ones.
Then two rounds of timings at ``MAIN_SHAPE`` causal beside SDPA's.  It
takes about half a minute on an H100; run from the repository root:

    python3 tools/torch_flash_f32_check.py

It prints each kernel's registers and spills, one line per case, and as
its last line one JSON object; it exits non-zero if a case fails.
"""
from __future__ import annotations

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

STEMS = ("flash_attn_fwd_f32_sm90", "flash_attn_bwd_f32_sm90",
         "flash_attn_fwd", "flash_attn_bwd")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_f32_check: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(list(STEMS))
    for stem in STEMS:
        print("ptxas (%s):\n%s"
              % (stem, cs.ptxas_summary(_build.build_info(stem)["log"])))
    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, bad = [], 0
    for (shape, causal, scale), strided in itertools.product(
            cs.FLASH_CASES, (False, True)):
        q, k, v = cs._qkv(shape, f32, gen, strided)
        do = cs._qkv(shape, f32, gen, strided)[0]
        out = att.flash_attention(q, k, v, causal, scale)
        ref = att.flash_attention_reference(q, k, v, causal, scale)
        diff = (out - ref).abs()
        err = diff.max().item()
        rel = (diff.amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max()
        got = att.flash_attention_backward(q, k, v, do, causal, scale)
        again = att.flash_attention_backward(q, k, v, do, causal, scale)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        berr, brels = cs._grad_errors(got, att.chunked_attention_grads(
            q, k, v, do, causal, scale))
        ok = (err <= cs.ATOL[f32] and rel.item() <= cs.ROW_RTOL[f32]
              and berr <= cs.BWD_ATOL[f32]
              and max(brels) <= cs.BWD_ROW_RTOL[f32] and same)
        bad += not ok
        case = dict(shape=shape, causal=causal, scale=scale, strided=strided,
                    design=att.design(f32, shape[-1]), fwd_err=err,
                    fwd_row_rel=rel.item(), bwd_err=berr,
                    bwd_row_rel=max(brels), repeat_equal=same, ok=ok)
        cases.append(case)
        print(" ".join("%s=%s" % kv for kv in case.items()), flush=True)
    q, k, v = cs._qkv(cs.MAIN_SHAPE, f32, gen)
    do = cs._qkv(cs.MAIN_SHAPE, f32, gen)[0]
    F = torch.nn.functional
    rounds = []
    for _ in range(2):
        r = {"fwd": cs.cuda_ms(lambda: att.flash_attention(q, k, v, True)),
             "sdpa": cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True)),
             "bwd": cs.cuda_ms(lambda: att.flash_attention_backward(
                 q, k, v, do, True), iters=10)}
        with torch.enable_grad():
            r["sdpa_bwd"] = cs.sdpa_backward_ms(q, k, v, do)
        rounds.append(r)
        print("timing ms at %s causal: %s" % (cs.MAIN_SHAPE, r), flush=True)
    print(json.dumps({"failed": bad, "cases": cases, "timings": rounds}))
    if bad:
        raise SystemExit("%d fp32 cases failed" % bad)


if __name__ == "__main__":
    main()
