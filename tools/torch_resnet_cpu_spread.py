#!/usr/bin/env python3
"""How far rounding moves two steps of ResNet-50 training, on the CPU.

Runs ``chip_smoke.py``'s parity configuration -- ``resnet50_v1``
(1000 classes) through ``Module`` at batch 2 x 3 x 224 x 224, two
``_fit_step``s with SGD lr 0.1, momentum 0.9, wd 1e-4, one seeded batch
-- in the JAX package and in the PyTorch package, each in fp64 and in
fp32, all from one Xavier initialization (the JAX package's, after
``mx.random.seed(0)``).  It prints the largest |difference| between
pairs of runs: the step-1 outputs, the parameters after step 1, the
step-2 outputs, the parameters after step 2 and the moving statistics
after step 2 (relative to max(1, |v|)).  These are the numbers behind
``chip_smoke.RESNET_PARITY_TOL``.  CPU only, a few minutes:

    JAX_PLATFORMS=cpu python3 tools/torch_resnet_cpu_spread.py

The last line is one JSON object with the numbers.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
import chip_smoke as cs  # noqa: E402

BATCH = cs.RESNET_PARITY_BATCH
SHAPE = (BATCH, 3, cs.RESNET_IMAGE, cs.RESNET_IMAGE)


def _module(pkg, dtype):
    with pkg.name.NameManager():
        net = pkg.gluon.model_zoo.vision.get_model("resnet50_v1",
                                                   classes=1000)
    if dtype != "float32":
        net.cast(dtype)
    s = pkg.sym.SoftmaxOutput(net(pkg.sym.var("data")),
                              pkg.sym.var("softmax_label"), name="softmax")
    mod = pkg.mod.Module(s, context=pkg.cpu())
    mod.bind(data_shapes=[pkg.io.DataDesc("data", SHAPE, dtype=dtype)],
             label_shapes=[pkg.io.DataDesc("softmax_label", SHAPE[:1],
                                           dtype=dtype)])
    return mod


def _host(params):
    return {k: torch.from_numpy(v.asnumpy().astype(np.float64))
            for k, v in params.items()}


def two_steps(pkg, dtype, init):
    """``chip_smoke._resnet_two_steps``'s record for ``pkg``, from the
    numpy ``init`` (arg, aux)."""
    mod = _module(pkg, dtype)
    mod.set_params(*[{k: pkg.nd.array(v.astype(dtype), ctx=pkg.cpu(),
                                      dtype=dtype) for k, v in d.items()}
                     for d in init])
    mod.init_optimizer(optimizer="sgd", optimizer_params=(
        ("learning_rate", cs.RESNET_LR), ("momentum", cs.RESNET_MOMENTUM),
        ("wd", cs.RESNET_WD)))
    rng = np.random.RandomState(0)
    x = rng.rand(*SHAPE).astype(np.float32)
    y = rng.randint(0, 1000, SHAPE[:1]).astype(np.float32)
    batch = pkg.io.DataBatch(
        [pkg.nd.array(x, ctx=pkg.cpu(), dtype=dtype)],
        [pkg.nd.array(y, ctx=pkg.cpu(), dtype=dtype)])
    res = {}
    for step in (1, 2):
        mod._fit_step(batch)
        arg, aux = mod.get_params()
        res["out%d" % step] = torch.from_numpy(
            mod.get_outputs()[0].asnumpy().astype(np.float64))
        res["params%d" % step] = _host(arg)
    res["aux2"] = _host(aux)
    return res


def main():
    init_mod = _module(mx, "float32")
    mx.random.seed(0)
    init_mod.init_params(mx.init.Xavier())
    init = [{k: v.asnumpy() for k, v in d.items()}
            for d in init_mod.get_params()]
    runs = {(pkg.__name__, dt): two_steps(pkg, dt, init)
            for dt in ("float64", "float32") for pkg in (mx, mt)}
    pairs = {
        "fp64 jax-port": (("mxnet_tpu", "float64"),
                          ("mxnet_tpu_torch", "float64")),
        "fp32 jax-port": (("mxnet_tpu", "float32"),
                          ("mxnet_tpu_torch", "float32")),
        "jax fp32-fp64": (("mxnet_tpu", "float32"), ("mxnet_tpu", "float64")),
        "port fp32-fp64": (("mxnet_tpu_torch", "float32"),
                           ("mxnet_tpu_torch", "float64")),
    }
    out = {}
    for name, (a, b) in pairs.items():
        out[name] = cs._resnet_diffs(runs[a], runs[b])
        print("%-15s largest |diff| %s" % (name, {
            k: "%.3g" % v for k, v in out[name].items()}))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
