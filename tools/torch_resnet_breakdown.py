#!/usr/bin/env python3
"""Where the time of one ResNet-50 training step goes on a CUDA card.

Builds ``chip_smoke.py``'s ResNet-50 training step at batch 32, 3 x 224 x
224, SGD with momentum, in fp32 (TF32 off) and bf16 (with ``--model``
another zoo model of its training phases at its batch and size:
Inception-v3 at 32 x 299², AlexNet at 512 x 224²): by default the
Module step (``bench.py``'s configuration, ``Module._fit_step`` through
``CachedTrainStep``), with ``--gluon`` the Gluon step of phase 16
(``hybridize()``, ``SoftmaxCrossEntropyLoss``, ``loss.backward()``,
``Trainer.step`` through the fused update).  For each it runs 5 warm-up
steps, then profiles 10 steps with ``torch.profiler`` and prints the
device time per step by group:

- by phase of the step: forward (the graph walk), backward (autograd),
  update (the multi-tensor SGD) and, for Gluon, the copies of the
  gradients into the Parameters' buffers ("grad write"); the input
  batch's copy, the loss and the moving statistics' write-back count in
  "other" (Gluon's loss forward by its ops);
- by operation: the forward kernels by the registry op that launched
  them (the tool wraps every op in a ``record_function`` while it
  profiles); the backward kernels by the autograd node that launched
  them, gathered into convolution, pooling, ReLU, the FC layer, the
  softmax and "BatchNorm and the rest" (the elementwise and reduction
  nodes of BatchNorm's formula, and the residual adds);
- the device operations per step, the device's busy share of the wall
  time, and the top kernels by name.

By default the step runs eagerly (inside ``capture.eager()``); with
``--captured`` it replays its captured CUDA graphs, as it does on the card
by default.  A replayed kernel was launched by a graph, not by an op, so
the captured step's device time is one group, "captured step", beside
its device operations, busy share and top kernels.

Each device operation is counted once, from the profiler's Kineto events:
a ``FunctionEvent``'s ``kernels`` can list a kernel that another event
with the same correlation id lists too.  A kernel's phase and operation
are those of the CPU op that launched it, found by correlation id.

Then, with the profiler off, it times 3 runs of 10 steps and prints each
run's median ms/step.  Run from the repository root on the card:

    python3 tools/torch_resnet_breakdown.py [--gluon] [--captured] \
        [--model inceptionv3|alexnet]

The last line is one JSON object with the numbers.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import capture  # noqa: E402
from mxnet_tpu_torch.gluon import block  # noqa: E402
from mxnet_tpu_torch.module import cached_step  # noqa: E402
from mxnet_tpu_torch.ops import registry  # noqa: E402

WARMUP, STEPS, RUNS = 5, 10, 3
BACKWARD_GROUPS = (("Convolution", "conv"), ("Pool", "pool"),
                   ("Maximum", "relu"), ("Mm", "fc"), ("Addmm", "fc"),
                   ("SemanticGrad", "softmax"))


@contextlib.contextmanager
def annotated():
    """Name every registry op's forward, and the step's phases, for the
    profiler; undone on exit."""
    saved_fns = {op: op.fn for op in set(registry.OP_REGISTRY.values())}
    saved = (cached_step._run_graph, block._run_graph,
             mt.optimizer.SGD.fused_update, mt.autograd._write_grads)

    def wrap(name, fn):
        def inner(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return inner
    for op, fn in saved_fns.items():
        op.fn = wrap("op:" + op.name, fn)
    cached_step._run_graph = wrap("phase:forward", saved[0])
    block._run_graph = wrap("phase:forward", saved[1])
    mt.optimizer.SGD.fused_update = wrap("phase:update", saved[2])
    mt.autograd._write_grads = wrap("phase:grad write", saved[3])
    try:
        yield
    finally:
        for op, fn in saved_fns.items():
            op.fn = fn
        (cached_step._run_graph, block._run_graph,
         mt.optimizer.SGD.fused_update, mt.autograd._write_grads) = saved


def _ranges(events, prefixes):
    """{thread: (starts, [(start, end, name)])} of the CPU ranges whose
    name starts with one of ``prefixes``, from the Kineto events (ns)."""
    by_thread = {}
    for k in events:
        if k.device_type() == DeviceType.CPU and k.name().startswith(
                prefixes):
            by_thread.setdefault(k.start_thread_id(), []).append(
                (k.start_ns(), k.end_ns(), k.name()))
    return {t: ([r[0] for r in sorted(rs)], sorted(rs))
            for t, rs in by_thread.items()}


def _innermost(ranges, thread, t):
    """The name of the innermost range on ``thread`` that holds time t."""
    starts, rs = ranges.get(thread, ([], []))
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        start, end, name = rs[i]
        if end >= t:
            return name
        i -= 1
    return None


def _group(phase, label):
    if phase == "forward":
        return "fwd " + (label[3:] if label else "?")
    if phase == "backward":
        node = label.split(": ")[-1] if label else "?"
        for key, group in BACKWARD_GROUPS:
            if key in node:
                return "bwd " + group
        return "bwd BatchNorm and the rest"
    return phase


# --model: the zoo models of chip_smoke.py's training phases, at their
# batch and image size
MODELS = {"resnet50_v1": (cs.RESNET_BATCH, cs.RESNET_IMAGE),
          "inceptionv3": (cs.INCEPTION_BATCH, cs.INCEPTION_IMAGE),
          "alexnet": (cs.ALEXNET_BATCH, cs.ALEXNET_IMAGE)}


def _module_step(dtype, model):
    """The Module step of phase 10 (20a for Inception-v3) and a check that
    it took CachedTrainStep."""
    gpu = mt.gpu(0)
    batch, image = MODELS[model]
    mod = cs.resnet_module(gpu, batch, dtype, image=image, model=model)
    cs.resnet_train_setup(mod)
    db = cs.resnet_batch(gpu, batch, dtype, image=image)

    def check():
        if mod._cached_step is None:
            raise SystemExit("the step did not take CachedTrainStep")
    return (lambda: mod._fit_step(db)), check


def _gluon_step(dtype, model):
    """The Gluon step of phase 16 (20b for AlexNet) and a check that it
    traced nothing and made one fused update a step."""
    from mxnet_tpu_torch.gluon import fused_trainer
    gpu = mt.gpu(0)
    batch, image = MODELS[model]
    net = cs.gluon_resnet(gpu, dtype, model=model)
    trainer = cs.gluon_trainer(net)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    db = cs.resnet_batch(gpu, batch, dtype, image=image)
    cs.gluon_step(net, trainer, loss_fn, db)  # traces the graph
    block.reset_trace_count()
    fused_trainer.reset_update_counts()
    state = {"n": 0}

    def step():
        state["n"] += 1
        cs.gluon_step(net, trainer, loss_fn, db)

    def check():
        if block.trace_count() != 0 or \
                fused_trainer.fused_update_count() != state["n"]:
            raise SystemExit("the Gluon step traced %d times and made %d "
                             "fused updates in %d steps"
                             % (block.trace_count(),
                                fused_trainer.fused_update_count(),
                                state["n"]))
    return step, check


def profile_steps(dtype, gluon=False, captured=False, model="resnet50_v1"):
    with contextlib.nullcontext() if captured else capture.eager():
        return _profile_steps(dtype, gluon, captured, model)


def _profile_steps(dtype, gluon, captured, model):
    flags = cs.tf32_flags() if dtype == torch.float32 else "bf16"
    step, check = (_gluon_step if gluon else _module_step)(dtype, model)
    batch = MODELS[model][0]
    path = "Gluon" if gluon else "Module"
    mode = "captured" if captured else "eager"
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    with annotated(), profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    check()
    events = prof.profiler.kineto_results.events()
    phases = _ranges(events, ("phase:",))
    ops = _ranges(events, ("op:", "autograd::engine::evaluate_function"))
    launchers = {}
    for k in events:
        if k.device_type() == DeviceType.CPU \
                and k.linked_correlation_id() == 0:
            launchers.setdefault(k.correlation_id(), []).append(k)
    groups, kernels, launches = {}, {}, 0
    for k in events:
        # the device's copies of the CPU ranges are annotations, not work
        if k.device_type() != DeviceType.CUDA \
                or k.name().startswith(("phase:", "op:")):
            continue
        ms = k.duration_ns() / 1e6 / STEPS
        cpu = max(launchers.get(k.linked_correlation_id(), ()),
                  default=None, key=lambda c: c.start_ns())
        phase = label = None
        if cpu is not None:
            phase = _innermost(phases, cpu.start_thread_id(), cpu.start_ns())
            label = _innermost(ops, cpu.start_thread_id(), cpu.start_ns())
        phase = phase[6:] if phase else None
        if phase is None:
            phase = "backward" if label and label.startswith(
                "autograd") else "other"
        g = "captured step" if captured else _group(phase, label)
        groups[g] = groups.get(g, 0.0) + ms
        kk = kernels.setdefault(k.name(), [0.0, 0])
        kk[0] += ms
        kk[1] += 1 / STEPS
        launches += 1
    device_ms = sum(groups.values())
    if device_ms == 0:
        raise SystemExit("torch.profiler recorded no device time")
    launches /= STEPS
    print("%s %s step %s (%s), %s, batch %d: wall %.3f ms/step "
          "(profiler on), device %.3f ms, busy %.1f%%, %.1f device ops per "
          "step" % (model, path, cs.DTYPE_NAME[dtype], flags, mode, batch,
                    wall_ms, device_ms, 100 * device_ms / wall_ms, launches))
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("  %-30s %9.4f ms  %5.1f%%" % (name, ms, 100 * ms / device_ms))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, count) in top:
        print("    %8.4f ms  x%-6.1f %s" % (ms, count, name[:110]))
    medians = []
    for _ in range(RUNS):
        times = cs._timed(step, STEPS)
        medians.append(sorted(times)[len(times) // 2])
    check()
    print("profiler off: median ms/step of %d runs of %d steps: %s"
          % (RUNS, STEPS, ["%.3f" % m for m in medians]))
    del step, check
    cs.free_card()
    return {"model": model, "path": path, "mode": mode,
            "dtype": cs.DTYPE_NAME[dtype], "flags": flags,
            "batch": batch, "steps": STEPS,
            "step_ms_medians": medians, "wall_ms": wall_ms,
            "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "device_ops_per_step": launches, "groups_ms": groups,
            "top": [[name[:80], ms, count] for name, (ms, count) in top]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gluon", action="store_true",
                    help="profile the Gluon step instead of Module's")
    ap.add_argument("--captured", action="store_true",
                    help="profile the replayed captured step, not the "
                    "eager one")
    ap.add_argument("--model", choices=sorted(MODELS), default="resnet50_v1",
                    help="the zoo model (at its chip_smoke.py batch and "
                    "image size)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_resnet_breakdown: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card)
    runs = [profile_steps(dt, args.gluon, args.captured, args.model)
            for dt in (torch.float32, torch.bfloat16)]
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()
