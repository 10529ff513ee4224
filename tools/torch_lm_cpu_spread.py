#!/usr/bin/env python3
"""How far rounding moves three LM train steps, on the CPU.

Runs ``chip_smoke.py``'s LM training parity configuration (2 layers,
d_model 128, 2 heads, d_ff 512, vocab 256, batch 2 x 200 tokens, lr 0.1;
``make_train_step`` and ``make_train_step_zero1`` with momentum 0.9) in
the PyTorch package on the CPU in fp64, fp32 and bf16, all from one fp32
init, and prints per step how far the fp32 and the bf16 runs lie from the
fp64 run: |loss difference| and the largest |difference| of the params and
of the momenta.  The attention of every run computes in fp32 (the plain
versions, like the kernels, widen to fp32 and no further), so the fp64 run
is fp64 everywhere else.  These are the numbers behind
``chip_smoke.LM_TRAIN_PARITY_TOL``.  CPU only, about a minute:

    python3 tools/torch_lm_cpu_spread.py

The last line is one JSON object with the numbers.
"""
from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main():
    torch.set_num_threads(min(4, torch.get_num_threads()))
    params, tokens, labels = cs.lm_train_parity_init()
    out = {}
    for builder in ("plain", "zero1"):
        runs = {dt: cs.lm_train_run("cpu", dt, builder, params, tokens,
                                    labels)
                for dt in (torch.float64, torch.float32, torch.bfloat16)}
        for dt in (torch.float32, torch.bfloat16):
            diffs = cs.lm_train_diffs(runs[dt], runs[torch.float64])
            name = "%s %s-fp64" % (builder, cs.DTYPE_NAME[dt])
            out[name] = diffs
            for i, d in enumerate(diffs):
                print("%-16s step %d: loss %.3g, params %.3g, momenta %.3g"
                      % (name, i + 1, d["loss"], d["params"], d["momenta"]))
        out["%s losses fp64" % builder] = [r["loss"]
                                          for r in runs[torch.float64]]
        out["%s largest |param| fp64" % builder] = max(
            t.abs().max().item() for t in runs[torch.float64][-1]["params"]
            .values())
        if builder == "zero1":
            out["zero1 largest |momentum| fp64"] = max(
                t.abs().max().item()
                for t in runs[torch.float64][-1]["momenta"].values())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
