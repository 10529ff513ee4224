#!/usr/bin/env python3
"""Phase 35 of ``chip_smoke.py`` alone, on one CUDA card: the Module
family and the predict API (ResNet-50 as a ``SequentialModule``, a
``PythonLossModule`` ending a chain, ``Predictor.load``, ``state_names``)
and JPEG decoding on the card (nvJPEG's ``imdecode``, ``ImageIter``,
``ImageDetIter`` into the SSD ops, a record dataset in ``DataLoader``
workers).  It builds every kernel, as ``chip_smoke.py`` does, and prints
the ``{"module_family": ...}`` line.  Run from the repository root on
the card:

    python3 tools/torch_module_family_chip.py
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
    print(json.dumps({"module_family": cs.phase_module_family(card)}),
          flush=True)


if __name__ == "__main__":
    main()
