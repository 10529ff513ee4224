#!/usr/bin/env python3
"""Phases 22-25 of ``chip_smoke.py`` alone, on one CUDA card: the packed
RNN layout against cuDNN's weight buffer, the ``RNN`` op's cases of the
op sweep card against CPU, its dropout in a captured step, the PTB LSTM
through ``BucketingModule`` in both cell variants (captured and eager,
peak memory with one graph pool and with one a bucket, busy share), the
Gluon word LM (captured and eager), and the fp64 card-against-CPU
parity.  It builds no kernel (none runs on these paths) and prints the
``{"rnn": ...}`` line that ``chip_smoke.py`` prints.  The PTB text is
not in the repository: the corpora are drawn from a seed.  Run from the
repository root on the card:

    python3 tools/torch_rnn_chip.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def op_cases(card):
    """The RNN cases of the op sweep (phase 21), card against CPU."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import test_utils
    cs.tf32_flags()
    worst = {}
    for case in test_utils.op_cases():
        if case["op"] != "RNN":
            continue
        cpu = test_utils.run_op_case(mt, case, mt.cpu())
        gpu = test_utils.run_op_case(mt, case, mt.gpu(0))
        worst[case["name"]] = max(cs._tol_ratio(g, c, case["tol"]) for g, c
                                  in zip(gpu[0] + gpu[1], cpu[0] + cpu[1]))
    cs.log("RNN op cases on %s, error over limit: %s" % (card, worst))
    if not all(v <= 1.0 for v in worst.values()):
        raise AssertionError("RNN op cases disagree: %s" % worst)
    return worst


def main():
    card = cs.phase_device()
    res = {"op_cases": op_cases(card)}
    res.update(cs.phase_rnn(card))
    print(json.dumps({"rnn": res}), flush=True)


if __name__ == "__main__":
    main()
