#!/usr/bin/env python3
"""Phase 36 of ``chip_smoke.py`` alone, on one CUDA card: the parallel
tier on 4 ranks that share the card over gloo (GPT-2 small tensor/data,
sequence and ZeRO-1 parallel against the one-card step, MoE and the
GPipe pipeline).  It builds every kernel, as ``chip_smoke.py`` does, and
prints the ``{"parallel": ...}`` line.  Run from the repository root on
the card:

    python3 tools/torch_parallel_chip.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main():
    card = cs.phase_device()
    cs.phase_build()
    res, launches = cs.phase_parallel(card)
    print(json.dumps({"parallel": res}), flush=True)


if __name__ == "__main__":
    main()
