#!/usr/bin/env python3
"""Phases 29 (the cv2-style resizes against cv2) and 30 (the kvstore and
several contexts) of ``chip_smoke.py`` alone, on one CUDA card:
``image.imresize`` and the resizing augmenters against ``cv2.resize``,
Inception-v3 through ``mt.kv.create("device")`` and through the example's
``fit``, the MNIST MLP on ``[gpu(0), cpu(0)]`` through Module and Gluon,
and the bucketed ``push_pull_all`` round.  It prints the
``{"cv2_resize": ...}`` and ``{"kvstore": ...}`` lines that
``chip_smoke.py`` prints.  Run from the repository root on the card:

    python3 tools/torch_kvstore_chip.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main():
    card = cs.phase_device()
    print(json.dumps({"cv2_resize": cs.phase_cv2_resize(card)}), flush=True)
    print(json.dumps({"kvstore": cs.phase_kvstore(card)}), flush=True)


if __name__ == "__main__":
    main()
