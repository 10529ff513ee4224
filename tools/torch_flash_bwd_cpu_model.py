#!/usr/bin/env python3
"""CPU models of the tensor-core flash-attention kernels' numerics.

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
   kernels use, where the dominant key's 2^0 is exactly 1).  Printed: dq's worst row-relative error per seed for each
   form, at (2, 4, 200, 64) causal, sm_scale 0.5.
3. ``split``: the fp32 kernels (``flash_attn_fwd_f32_sm90.cu``,
   ``flash_attn_bwd_f32_sm90.cu``) take every product on the tensor cores
   as six products of bf16 parts (``split_bf16x3``, ``split_matmul``).
   Printed: the forward model's row-relative error against an fp64
   reference beside plain fp32's, and the gradient model's (the plain
   backward's formula with every product split) against the plain
   backward, per seed, at the cases above.

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


# The fp32 kernels' six products a_i b_j (i + j <= 2), smallest first
# (sm90_common.cuh: split_a, split_b).
SPLIT_ORDER = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def split_bf16x3(x):
    """The fp32 kernels' split (``sm90_common.cuh``: ``split3``): fp32 x as
    three fp32 tensors holding bf16 values, x0 = bf16(x), x1 = bf16(x - x0),
    x2 = bf16(x - x0 - x1), each rounded to nearest even; x0 + x1 + x2 == x
    exactly for 0 and 2^-110 <= |x| < 2^128 - 2^119."""
    x0 = x.to(torch.bfloat16).float()
    r = x - x0
    x1 = r.to(torch.bfloat16).float()
    return x0, x1, (r - x1).to(torch.bfloat16).float()


def split_matmul(a, b):
    """a @ b as the fp32 kernels take it: the six products a_i @ b_j of the
    parts with i + j <= 2, each exact in fp32 term by term and summed in
    fp32, added smallest first."""
    pa, pb = split_bf16x3(a), split_bf16x3(b)
    out = None
    for i, j in SPLIT_ORDER:
        t = torch.matmul(pa[i], pb[j])
        out = t if out is None else out + t
    return out


def split_attention(q, k, v, causal, sm_scale):
    """The fp32 forward kernel's arithmetic: x = (q k^T) scale log2e with q
    k^T split, masked to -1e30, p = 2^(x - max), l = sum p, o = (p v) / l
    with p v split."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    x = split_matmul(q, k.transpose(-1, -2)) * (scale * LOG2E)
    x = x.masked_fill(_mask(q.shape[2], causal), -1e30)
    p = torch.exp2(x - x.amax(-1, keepdim=True))
    return split_matmul(p, v) / p.sum(-1, keepdim=True).clamp_min(1e-30)


def split_attention_grads(q, k, v, do, causal, sm_scale):
    """``chunked_attention_grads``'s formula (one chunk) with every product
    split as the fp32 backward kernel splits it: what the split alone
    changes."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    masked = _mask(q.shape[2], causal)
    s = split_matmul(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(s.masked_fill(masked, -1e30), dim=-1)
    dv = split_matmul(p.transpose(-1, -2), do)
    dp = split_matmul(do, v.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).masked_fill(masked, 0)
    dq = split_matmul(ds, k) * scale
    dk = split_matmul(ds.transpose(-1, -2), q) * scale
    return dq, dk, dv


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
    out["split"] = {"forward": {}, "grads": {}}
    for shape, causal, scale in CASES + [((1, 4, 1024, 64), True, None)]:
        rels = {}
        q, k, v = _inputs(shape, 0, torch.float32)[:3]
        sc = scale if scale is not None else 1.0 / math.sqrt(shape[-1])
        ref = torch.softmax((torch.matmul(q.double(), k.double().transpose(
            -1, -2)) * sc).masked_fill(_mask(shape[2], causal), -1e30),
            dim=-1) @ v.double()
        for name, got in (("split", split_attention(q, k, v, causal, scale)),
                          ("plain fp32", att.flash_attention_reference(
                              q, k, v, causal, scale))):
            diff = (got.double() - ref).abs()
            rels[name] = (diff.amax(-1) / ref.abs().amax(-1)).max().item()
        key = "%s causal=%s scale=%s" % (shape, causal, scale)
        out["split"]["forward"][key] = rels
        print("split forward %s: row-relative against fp64 %s" % (key, rels))
    for shape, causal, scale in CASES:
        errs = []
        for seed in range(args.seeds):
            q, k, v, do = _inputs(shape, seed, torch.float32)
            ref = att.chunked_attention_grads(q, k, v, do, causal, scale)
            got = split_attention_grads(q, k, v, do, causal, scale)
            errs.append(max(cs._grad_errors(got, ref)[1]))
        key = "%s causal=%s scale=%s" % (shape, causal, scale)
        out["split"]["grads"][key] = errs
        print("split grads %s: row-relative against the plain backward per "
              "seed %s (limit %.4g)" % (key, ["%.3g" % e for e in errs],
                                       cs.BWD_ROW_RTOL[torch.float32]))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
