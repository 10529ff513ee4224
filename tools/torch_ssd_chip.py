#!/usr/bin/env python3
"""Phase 31 of ``chip_smoke.py`` (the op long tail: the NMS kernel, the
SSD ops, the toy SSD and Custom ops) alone, on one CUDA card, with the
NMS kernel's build first; ``--sweep`` adds phase 21 (the op sweep, card
against CPU), which holds the long tail's other ops.  It prints the
``{"long_tail": ...}`` line (and ``{"ops": ...}``) that ``chip_smoke.py``
prints.  Run from the repository root on the card:

    python3 tools/torch_ssd_chip.py [--sweep]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main():
    card = cs.phase_device()
    from mxnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    seconds = _build.build_all(["nms"])
    cs.log("build: %s in %.1f s wall\nptxas (nms):\n%s"
           % (seconds, time.perf_counter() - t0,
              cs.ptxas_summary(_build.build_info("nms")["log"])))
    if "--sweep" in sys.argv:
        print(json.dumps({"ops": cs.phase_op_sweep(card)}), flush=True)
    print(json.dumps({"long_tail": cs.phase_long_tail(card)}), flush=True)


if __name__ == "__main__":
    main()
