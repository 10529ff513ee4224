#!/usr/bin/env python3
"""Phases 26-28 of ``chip_smoke.py`` alone, on one CUDA card: the JPEG
probe, a ``.rec`` of 2,048 seeded JPEGs, the resize kernel's rounds
against their plain version and timed, ``ImageRecordIter`` (nvJPEG on the
card) by thread count, the copy of a batch to the card, ``mean_rgb`` and
``scale`` on the card, ``allow_corrupt`` over corrupt records, ResNet-50
through Gluon and through ``Module.fit`` fed from the file, and LeNet
through ``Module.fit`` over ``MNISTIter`` and through Gluon over
``DataLoader``.  It builds only the
loader's source (``ops/csrc/image_nvjpeg.cu``) and prints the
``{"data": ...}`` line that ``chip_smoke.py`` prints, without phase 16's
figure beside phase 27's.  Run from the repository root on the card:

    python3 tools/torch_data_chip.py
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
    seconds = _build.build_all(["image_nvjpeg"])
    cs.log("build: %s in %.1f s wall\nptxas (image_nvjpeg):\n%s"
           % (seconds, time.perf_counter() - t0,
              cs.ptxas_summary(_build.build_info("image_nvjpeg")["log"])))
    res, _ = cs.phase_data(card, None)
    print(json.dumps({"data": res}), flush=True)


if __name__ == "__main__":
    main()
