#!/usr/bin/env python3
"""Where the host time of phase 32b's sparse linear step goes
(``chip_smoke.py``: the example's loop, ``forward_backward`` + ``update``
at avazu-app's width, batch 8192, without a store or with
``kv.create("local")``), on one CUDA card: the step's median ms over 40
steps after 8, then ``cProfile`` over 40 more, the functions with the
most own time and the most time below them, per step.  Prints one JSON
line.  Run from the repository root on the card:

    python3 tools/torch_sparse_step_host.py [--store local]
"""
import argparse
import cProfile
import json
import os
import pstats
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

WARMUP, TIMED = 8, 40


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    import mxnet_tpu_torch as mt
    card = cs.phase_device()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))) as tmp:
        path, _ = cs.write_sparse_data(tmp, mt)
        it = mt.io.LibSVMIter(data_libsvm=path, data_shape=(cs.SPARSE_DIM,),
                              batch_size=cs.SPARSE_BATCH)
        batches = [b for b, _ in zip(it, range(8))]
    kv = mt.kv.create(args.store) if args.store else None
    mod = cs.sparse_module(mt, cs.sparse_linear_symbol(mt, cs.SPARSE_DIM),
                           mt.gpu(0), it.provide_data, it.provide_label,
                           "sgd", cs.SPARSE_OPT, kv=kv)

    def steps(n):
        out = []
        for i in range(n):
            t0 = time.perf_counter()
            cs.sparse_linear_step(mod, batches[i % len(batches)], kv)
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return out
    steps(WARMUP)
    ms = float(np.median(steps(TIMED)))
    prof = cProfile.Profile()
    prof.enable()
    steps(TIMED)
    prof.disable()
    stats = pstats.Stats(prof)

    def top(key, n=25):
        rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][key])[:n]
        return [["%s:%d %s" % (os.path.basename(f), line, fn),
                 1e3 * v[key] / TIMED] for (f, line, fn), v in rows]
    print(json.dumps({"sparse_step_host": {
        "card": card, "store": args.store, "ms_per_step": ms,
        "own_ms_per_step": top(2), "cumulative_ms_per_step": top(3)}}),
        flush=True)


if __name__ == "__main__":
    main()
