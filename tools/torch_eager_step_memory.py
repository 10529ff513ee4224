#!/usr/bin/env python3
"""Device memory of eager recorded Gluon training steps: ResNet-50 v1
from the model zoo, not hybridized (every layer one recorded op), at
batch 32 in fp32 (TF32 off), stepped as a training loop steps it
(``out, loss = step()``, so the last step's outputs are held while the
next step runs).  For each step it reads ``torch.cuda.max_memory_allocated``
over the step and ``torch.cuda.memory_allocated`` after it, while
``loss`` is held: what a recorded output keeps alive shows in both.
Prints one JSON line with the card's name and power limit.  Run from the
repository root on the card:

    python3 tools/torch_eager_step_memory.py [--steps 4] [--root DIR]

``--root`` imports ``mxnet_tpu_torch`` from another checkout, so that two
trees are compared in one run of the card.
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--root", default=REPO)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root] + ([REPO] if root != REPO else [])
    import torch
    import chip_smoke as cs
    import mxnet_tpu_torch as mt
    card = cs.phase_device()
    gpu = mt.gpu(0)
    with mt.name.NameManager():
        net = mt.gluon.model_zoo.vision.get_model("resnet50_v1",
                                                  classes=1000)
    mt.random.seed(0)
    net.initialize(mt.initializer.Xavier(), ctx=gpu)
    trainer = cs.gluon_trainer(net)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    db = cs.resnet_batch(gpu, cs.RESNET_BATCH, torch.float32)
    peaks, held = [], []
    out = loss = None
    for _ in range(args.steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, loss = cs.gluon_step(net, trainer, loss_fn, db)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        held.append(torch.cuda.memory_allocated())
    print(json.dumps(dict(
        root=os.path.relpath(root, REPO), card=card, batch=cs.RESNET_BATCH,
        dtype="float32", hybridized=False,
        loss_finite=bool(torch.isfinite(loss._data).all()),
        step_peak_bytes=peaks, held_after_step_bytes=held,
        mt_file=os.path.relpath(mt.__file__, REPO))), flush=True)


if __name__ == "__main__":
    main()
