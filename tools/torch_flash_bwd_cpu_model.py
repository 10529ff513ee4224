#!/usr/bin/env python3
"""CPU models of the tensor-core flash-attention backward's numerics.

``ops/csrc/flash_attn_bwd_sm90.cu`` differs from the plain backward
(``attention.chunked_attention_grads``) in two ways that the card's check
(``chip_smoke.BWD_ROW_RTOL``, measured by ``chip_smoke._grad_errors``)
has to absorb:

1. ``rounding``: P and dS are rounded to bf16/fp16 where they enter a
   tensor-core product; everything else stays as the plain version
   computes it.  Printed: the worst row-relative error over dq, dk and dv
   against the plain version, per dtype and case, over ``--seeds`` numpy
   seeds.
2. ``statistics``: where p comes from.  In fp32, with no rounding to the
   16-bit types, p taken as 2^(x - lse) from a row log-sum-exp ("lse")
   against p = 2^(x - max) / sum ("max", the online statistics the
   kernel and the SIMT kernel use, where the dominant key's 2^0 is
   exactly 1).  Printed: dq's worst row-relative error per seed for each
   form, at (2, 4, 200, 64) causal, sm_scale 0.5.

CPU only, about a minute:

    python3 tools/torch_flash_bwd_cpu_model.py [--seeds 10]

The last line is one JSON object with the numbers.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mxnet_tpu_torch.ops import attention as att  # noqa: E402

CASES = [((2, 4, 200, 64), True, 0.5), ((1, 3, 130, 128), True, None)]
LOG2E = 1.4426950408889634


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mask(s, causal):
    pos = torch.arange(s)
    return (pos[:, None] < pos[None, :]) if causal \
        else torch.zeros((s, s), dtype=torch.bool)


def tensor_core_rounding_model(q, k, v, do, causal, sm_scale):
    """The plain backward with the tensor-core kernel's two extra
    roundings: P and dS rounded to the input type where they enter a
    product (dv = P^T do, dq = dS k, dk = dS^T q, sums in fp32); p, dp and
    delta = sum_j p dp stay fp32, as in the kernel."""
    dtype = q.dtype
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    masked = _mask(q.shape[2], causal)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    sc = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.softmax(sc.masked_fill(masked, -1e30), dim=-1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True))).masked_fill(masked, 0)
    p16, ds16 = p.to(dtype).float(), ds.to(dtype).float()
    dq = torch.matmul(ds16, kf) * scale
    dk = torch.matmul(ds16.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p16.transpose(-1, -2), dof)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def dq_by_statistics(q, k, v, do, causal, sm_scale, form):
    """dq in fp32 with p from the row's max and sum ("max") or from its
    log-sum-exp in log2 units ("lse"), delta = sum_j p dp."""
    masked = _mask(q.shape[2], causal)
    x = (torch.matmul(q, k.transpose(-1, -2)) * (sm_scale * LOG2E))
    x = x.masked_fill(masked, -1e30)
    m = x.amax(-1, keepdim=True)
    e = torch.exp2(x - m)
    if form == "max":
        p = e / e.sum(-1, keepdim=True)
    else:
        lse = m + torch.log2(e.sum(-1, keepdim=True))
        p = torch.exp2(x - lse)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return torch.matmul(ds, k) * sm_scale


def _inputs(shape, seed, dtype):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
            for _ in range(4)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=10)
    args = ap.parse_args()
    cs = _chip_smoke()
    out = {"rounding": {}, "statistics": {}}
    for dtype in (torch.bfloat16, torch.float16):
        for shape, causal, scale in CASES:
            worst = 0.0
            for seed in range(args.seeds):
                q, k, v, do = _inputs(shape, seed, dtype)
                ref = att.chunked_attention_grads(q, k, v, do, causal, scale)
                got = tensor_core_rounding_model(q, k, v, do, causal, scale)
                worst = max(worst, max(cs._grad_errors(got, ref)[1]))
            key = "%s %s causal=%s scale=%s" % (cs.DTYPE_NAME[dtype], shape,
                                                causal, scale)
            out["rounding"][key] = worst
            print("rounding model %s: worst row-relative %.4g over %d seeds "
                  "(limit %.4g)" % (key, worst, args.seeds,
                                    cs.BWD_ROW_RTOL[dtype]))
    shape, causal, scale = CASES[0]
    for form in ("lse", "max"):
        errs = []
        for seed in range(args.seeds):
            q, k, v, do = _inputs(shape, seed, torch.float32)
            ref = att.chunked_attention_grads(q, k, v, do, causal, scale)[0]
            got = dq_by_statistics(q, k, v, do, causal, scale, form)
            errs.append(max(cs._grad_errors([got], [ref])[1]))
        out["statistics"][form] = errs
        print("fp32 dq, p from the row %s, %s causal sm_scale %s: "
              "row-relative per seed %s"
              % (form, shape, scale, ["%.4g" % e for e in errs]))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
