#!/usr/bin/env python3
"""Phases 20 (the vision zoo) and 21 (the op sweep) of ``chip_smoke.py``
alone, on one CUDA card: Inception-v3 through Module and AlexNet through
Gluon training, the zoo's scoring, each family card against CPU in fp64,
and every op of the elemwise, reduce, matrix and nn modules and every
random op card against CPU.  It builds no kernel (none runs on these
paths) and prints the ``{"zoo": ...}`` and ``{"ops": ...}`` lines that
``chip_smoke.py`` prints.  Run from the repository root on the card:

    python3 tools/torch_zoo_chip.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main():
    card = cs.phase_device()
    print(json.dumps({"zoo": cs.phase_zoo(card)}), flush=True)
    print(json.dumps({"ops": cs.phase_op_sweep(card)}), flush=True)


if __name__ == "__main__":
    main()
