#!/usr/bin/env python3
"""Phase 32 of ``chip_smoke.py`` (sparse storage: the CSR kernels against
their plain versions, the linear classifier at avazu-app's width, its
fp64 steps card against CPU, the FM and the sparse files) alone, on one
CUDA card, with the ``csr_dot`` build first.  It prints the line that
``chip_smoke.py`` prints for phase 32.  Run from the repository root on
the card:

    python3 tools/torch_sparse_chip.py
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
    seconds = _build.build_all(["csr_dot"])
    cs.log("build: %s in %.1f s wall\nptxas (csr_dot):\n%s"
           % (seconds, time.perf_counter() - t0,
              cs.ptxas_summary(_build.build_info("csr_dot")["log"])))
    sparse = cs.phase_sparse(card)
    print(json.dumps({"sparse": {k: v for k, v in sparse.items()
                                 if k != "kernels"},
                      "sparse_kernels": {k: v for k, v in
                                         sparse["kernels"].items()
                                         if k != "checks"}}), flush=True)


if __name__ == "__main__":
    main()
