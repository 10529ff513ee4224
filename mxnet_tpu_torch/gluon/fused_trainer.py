"""The fused Gluon ``Trainer`` step: the whole weight update in one call.

Counterpart of ``mxnet_tpu/gluon/fused_trainer.py`` (``run_fused_step``
:519), on one rank.  The per-parameter loop of ``Trainer._loop_step``
runs one ``Updater`` call, and so one update per parameter; the fused
step makes the optimizer's state, update counts, learning rates and
weight decays exactly as that loop does, then updates every parameter
and its state with one ``Optimizer.fused_update`` call over lists of
tensors (PyTorch's multi-tensor ops), in place.  The two paths agree bit
for bit.  The reference's ZeRO plan (ROADMAP A.8), its guardian, chaos
and overlap hooks (A.10, A.7) and its telemetry spans (A.11) are not
ported.

On the card the fused step is one captured program (``capture``),
replayed once a step over the Parameters' weights, gradients and states
in place, with ``rescale_grad``, lr, wd and Adam's t traced: with the
forward and backward graphs of a hybridized block, a Gluon step is three
replays.  ``profiler.counter("program_calls")`` counts one a fused step
(replayed or eager) and one a parameter on the loop.

``MXNET_FUSED_TRAINER=0`` turns the fused step off (read at import;
:func:`refresh_from_env` reads it again).  :func:`fused_update_count` and
:func:`loop_update_count` count the updates of each path.
"""
from __future__ import annotations

import os

from .. import capture, profiler
from .. import random as _random
from ..optimizer import TracedHyper, _state_raw, _state_tensors

__all__ = ["fused_trainer_enabled", "refresh_from_env", "run_fused_step",
           "fused_update_count", "loop_update_count", "reset_update_counts"]


def _env_enabled():
    return os.environ.get("MXNET_FUSED_TRAINER", "1").strip().lower() \
        not in ("0", "false", "off", "no")


_ENABLED = _env_enabled()
_fused_updates = 0
_loop_updates = 0


def refresh_from_env():
    """Read ``MXNET_FUSED_TRAINER`` again."""
    global _ENABLED
    _ENABLED = _env_enabled()


def fused_trainer_enabled():
    return _ENABLED


def fused_update_count():
    """``fused_update`` calls (one per fused ``Trainer.step``) since the
    last :func:`reset_update_counts`."""
    return _fused_updates


def loop_update_count():
    """Per-parameter updates of ``Trainer._loop_step`` since the last
    :func:`reset_update_counts`."""
    return _loop_updates


def reset_update_counts():
    global _fused_updates, _loop_updates
    _fused_updates = _loop_updates = 0


def _count_loop_update():
    global _loop_updates
    _loop_updates += 1
    profiler.bump("program_calls")


def run_fused_step(trainer, slots):
    """One fused step over ``slots`` ([(slot index, Parameter)]): states,
    update counts and lr/wd per slot as the loop makes them, then one
    ``fused_update`` of every weight and state, in place: on the card one
    replay of the step's captured program, its hyper-parameters traced
    (``optimizer.TracedHyper``), else one eager call."""
    global _fused_updates
    opt, updater = trainer._optimizer, trainer._updater
    for slot, param in slots:
        if slot not in updater.states:
            updater.states[slot] = opt.create_state(slot, param.data())
        opt._update_count(slot)
    lrs = [opt._get_lr(slot) for slot, _ in slots]
    wds = [opt._get_wd(slot) for slot, _ in slots]
    counts = [opt._index_update_count[slot] for slot, _ in slots]
    weights = [param.data()._data for _, param in slots]
    grads = [param.grad()._data for _, param in slots]
    states = [_state_raw(updater.states[slot]) for slot, _ in slots]
    _fused_updates += 1
    graph = capture.graph_for(weights[0].device)
    if graph is None:
        profiler.bump("program_calls")
        opt.fused_update(weights, grads, states, lrs, wds, counts)
        return
    hyper = TracedHyper(opt, lrs, wds, counts)
    gens = [_random.generator(slots[0][1].data().context)] \
        if opt.draws_random else []
    step = ("trainer_step", tuple(slot for slot, _ in slots))
    prog = trainer._programs.program(
        step + (hyper.key,), graph, weights[0].device,
        lambda: [lambda values: opt.fused_update(
            weights, grads, states, **hyper.unpack(values)) or []],
        [hyper.values], weights + grads + _state_tensors(states), gens,
        family=hyper.family and step + (hyper.family,))
    prog.replay(0, [hyper.values])
