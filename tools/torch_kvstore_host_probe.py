#!/usr/bin/env python3
"""Whether the Python heap or the cyclic garbage collector sets the pace
of ``chip_smoke.py`` phase 30's host-bound paths on one CUDA card: the
Inception-v3 step with the update on ``mt.kv.create("device")`` (30a,
ms/step median of 10 after 3) and the bucketed ``push_pull_all`` round
against the per-key loop (30c), each run three ways in one process: as
they are, with 3,000,000 more live Python objects, and with those and
``gc.freeze()``.  Prints one JSON line a way.  Run from the repository
root on the card:

    python3 tools/torch_kvstore_host_probe.py
"""
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

BALLAST = 3_000_000


def run(card):
    t0 = time.perf_counter()
    step = {cs.DTYPE_NAME[dt]: cs.kv_inception(card, dt)["step_ms_median"]
            for dt in (torch.float32, torch.bfloat16)}
    rnd = {cs.DTYPE_NAME[dt]: {k: v for k, v in cs.kv_bucketed_round(
        card, dt).items() if k.endswith("_ms")}
        for dt in (torch.float32, torch.bfloat16)}
    return dict(store_step_ms=step, round=rnd,
                seconds=time.perf_counter() - t0)


def main():
    card = cs.phase_device()
    ballast = None
    for mode in ("plain", "ballast", "ballast_gc_frozen"):
        if mode == "ballast":
            ballast = [[i, str(i)] for i in range(BALLAST)]
        elif mode == "ballast_gc_frozen":
            gc.collect()
            gc.freeze()
        print(json.dumps({mode: dict(run(card), live_objects=len(
            gc.get_objects()), ballast=len(ballast or ()))}), flush=True)


if __name__ == "__main__":
    main()
