#!/usr/bin/env python3
"""Where an armed ``Monitor`` batch's time goes: ResNet-50 through
``Module`` at batch 32, fp32 (TF32 off), each batch ``forward_backward``
then ``update`` (the loop ``fit`` runs under a monitor), timed on the
host clock with a synchronize (median of ``--batches`` after 2), in
turns:

- ``replayed``: no monitor, the executor's captured ``forward_backward``;
- ``eager``: no monitor, inside ``capture.eager()``;
- ``armed_none``: a monitor armed every batch whose pattern matches no
  output (the node-by-node walk alone);
- ``armed_stats``: armed every batch over the 54 conv and FC outputs
  (``chip_smoke.API_PATTERN``), each statistic read back by ``toc``;

each with cuDNN deterministic (as phase 34 of ``chip_smoke.py`` runs)
and not.  Prints one JSON line.  Run from the repository root on the
card:

    python3 tools/torch_monitor_cost.py [--batches 8]
"""
import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def run(mode, batches):
    """ms of each batch in ``mode``."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import capture
    mod = cs.resnet_module(mt.gpu(0), cs.RESNET_BATCH, torch.float32)
    cs.resnet_train_setup(mod)
    mon = None
    if mode.startswith("armed"):
        pattern = cs.API_PATTERN if mode == "armed_stats" else "^$"
        mon = mt.Monitor(interval=1, pattern=pattern)
        mod.install_monitor(mon)
    db = cs.resnet_batch(mt.gpu(0), cs.RESNET_BATCH, torch.float32)
    times = []
    scope = capture.eager() if mode == "eager" else contextlib.nullcontext()
    with scope:
        for _ in range(batches + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mon is not None:
                mon.tic()
            mod.forward_backward(db)
            mod.update()
            if mon is not None:
                mon.toc()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    del mod
    cs.free_card()
    return times[2:]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=8)
    args = ap.parse_args()
    card = cs.phase_device()
    cs.tf32_flags()
    res = {"card": card, "batch": cs.RESNET_BATCH}
    for det in (True, False):
        torch.backends.cudnn.deterministic = det
        key = "deterministic" if det else "default"
        res[key] = {}
        for mode in ("replayed", "eager", "armed_none", "armed_stats"):
            t = run(mode, args.batches)
            res[key][mode] = {"median_ms": cs._median(t), "ms": t}
            cs.log("%s %s: median %.3f ms" % (key, mode, cs._median(t)))
    print(json.dumps({"monitor_cost": res}), flush=True)


if __name__ == "__main__":
    main()
