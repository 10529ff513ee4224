#!/usr/bin/env python3
"""Where the time of one LM inference batch goes on a CUDA card.

Runs the PyTorch port's transformer LM at GPT-2 small widths (12 layers,
d_model 768, 12 heads, d_ff 3072, vocab 50257; seeded random weights) on
one batch of 8 x 1024 tokens to logits and mean NLL, in fp32 and bf16, under
``torch.profiler``, and prints the device time by kernel, grouped into the
flash-attention kernel, matrix products and the rest, with the device's
busy share of the profiled wall time.  Run from the repository root on
the card:

    python3 tools/torch_lm_breakdown.py

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

from mxnet_tpu_torch.models import transformer as tr  # noqa: E402

GPT2_SMALL = dict(vocab=50257, d_model=768, n_heads=12, d_ff=3072,
                  n_layers=12, max_len=1024)
BATCH, SEQ, FORWARDS = 8, 1024, 3


def _group(name):
    low = name.lower()
    if "flash_attn_fwd" in low:
        return "flash_attn_fwd"
    if any(w in low for w in ("gemm", "cutlass", "sm90_xmma", "nvjet")):
        return "matmul"
    return "other"


def breakdown(dtype):
    cfg = tr.TransformerLMConfig(dtype=dtype, **GPT2_SMALL)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = tr.TransformerLM(cfg, tr.init_transformer_params(gen, cfg))
    seq = torch.randint(0, cfg.vocab, (BATCH, SEQ + 1), generator=gen,
                        device="cuda")
    tokens, labels = seq[:, :-1], seq[:, 1:]
    with torch.inference_mode():
        tr.nll_from_logits(model(tokens), labels)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(FORWARDS):
                tr.nll_from_logits(model(tokens), labels)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / FORWARDS
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        k = kernels.setdefault(evt.key, [0.0, 0])
        k[0] += us / 1e3 / FORWARDS
        k[1] += evt.count // FORWARDS
    device_ms = sum(ms for ms, _ in kernels.values())
    if device_ms == 0:
        raise SystemExit("torch.profiler recorded no device time")
    groups = {}
    for name, (ms, _) in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    print("\n%s: wall %.3f ms/forward (profiler on), device %.3f ms, "
          "busy %.1f%%" % (dtype, wall_ms, device_ms,
                           100 * device_ms / wall_ms))
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("  %-16s %8.3f ms  %5.1f%%" % (name, ms, 100 * ms / device_ms))
    for name, (ms, count) in top:
        print("    %8.3f ms  x%-4d %s" % (ms, count, name[:110]))
    del model
    torch.cuda.empty_cache()
    return {"dtype": str(dtype).replace("torch.", ""),
            "wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "groups_ms": groups,
            "top": [[name[:80], ms, count] for name, (ms, count) in top]}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_lm_breakdown: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = [breakdown(dt) for dt in (torch.float32, torch.bfloat16)]
    print(json.dumps({"card": card, "batch": BATCH, "seq": SEQ,
                      "breakdown": rows}))


if __name__ == "__main__":
    main()
