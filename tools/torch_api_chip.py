#!/usr/bin/env python3
"""Phase 34 of ``chip_smoke.py`` alone, on one CUDA card: the API
surface (ResNet-50's monitored ``Module.fit``, ``FeedForward`` over the
MNIST MLP through the scale kernel, second-order gradients through a
hybridized block, ``dot`` of a CSR and flash attention, initializers,
symbols and parameters).  It builds every kernel, as ``chip_smoke.py``
does, and prints the ``{"api_surface": ...}`` line.  Run from the
repository root on the card:

    python3 tools/torch_api_chip.py
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
    print(json.dumps({"api_surface": cs.phase_api_surface(card)}),
          flush=True)


if __name__ == "__main__":
    main()
