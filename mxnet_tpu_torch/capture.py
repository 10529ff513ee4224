"""One program a step: a training step captured once as CUDA graphs and
replayed.

Counterpart of ``jax.jit`` with donated buffers, the JAX package's
contract for its training steps: ``module/cached_step.py:82-128``
(forward, backward and update in one donated program),
``gluon/block.py:327-447`` (``_CachedOp``: the forward one program, its
``jax.vjp`` a second), ``gluon/fused_trainer.py:303-444`` (the whole
update one donated program) and ``models/transformer.py:189-205`` (the
two LM train steps).  A :class:`Program` is one such step: one or more
stages (a forward and then its backward), each captured into one CUDA
graph, all in one memory pool.

- A :class:`StepCache` keys programs on what JAX would retrace on: the
  caller's key (training mode, the optimizer's class and static
  hyper-parameters) and the shapes, dtypes and devices of the inputs.  It
  holds at most :data:`MAX_PROGRAMS`, dropping the least recently used.
- Capture: the buffers the step reads and writes (parameters, moving
  statistics, optimizer states, gradients) are copied aside; the stages
  run :data:`WARMUP_RUNS` times on a side stream, so that every
  cuDNN/cuBLAS handle and workspace exists and no hand-written kernel is
  launched for the first time under capture; each stage is captured;
  then the buffers and the random generators are put back, so the
  warm-ups and the capture leave no trace.  Replays do the step.
- Inputs are copied into static buffers before a replay (a host tensor,
  such as the hyper-parameters, through pinned memory).  Outputs are
  cloned on the way out, so an array step k returned keeps its value
  after step k+1, as a JAX output does.
- The program keeps the address, shape, dtype and strides of every
  buffer and compares them before each replay: a buffer rebound since
  the capture (``Updater.set_states``, a re-``initialize``, a ``cast``)
  recaptures, counted in ``graph_captures``.  The program holds the
  captured tensors, so it never replays into freed memory.
- ``profiler`` counters: the delta that each stage's capture moved is
  added again on each of its replays (a kernel's launch count stays its
  launches on the device; the warm-ups count as the launches they are),
  with one ``graph_replays`` and one ``program_calls``.
- A capture that fails raises ``MXNetError`` naming the step and the
  cause; nothing falls back to eager.  No other graph may be destroyed
  while one captures, so the garbage collector runs before a capture
  and waits during it.

On the CPU every entry point stays eager.  On the card the only eager
route is :func:`eager`, the oracle of the tests and of ``chip_smoke.py``.
:func:`stand_in` lets a test drive the capture plumbing on the CPU with a
graph class of its own.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import threading
from collections import OrderedDict

import torch

from .base import MXNetError
from . import profiler

__all__ = ["eager", "stand_in", "graph_for", "Program", "StepCache",
           "WARMUP_RUNS", "MAX_PROGRAMS"]

WARMUP_RUNS = 3
MAX_PROGRAMS = 8


class _Mode(threading.local):
    def __init__(self):
        self.eager = 0
        self.stand_in = None


_MODE = _Mode()


@contextlib.contextmanager
def eager():
    """Run every entry point eagerly inside the block, on the card too."""
    _MODE.eager += 1
    try:
        yield
    finally:
        _MODE.eager -= 1


@contextlib.contextmanager
def stand_in(graph_class):
    """Capture with ``graph_class`` inside the block, on any device: a
    test's stand-in for :class:`CudaGraph` (same constructor, ``pool``,
    ``warmup_runs``, ``capture`` and ``replay``)."""
    prev, _MODE.stand_in = _MODE.stand_in, graph_class
    try:
        yield
    finally:
        _MODE.stand_in = prev


def graph_for(device):
    """The graph class an entry point on ``device`` captures with, or None
    where it runs eagerly (the CPU, or inside :func:`eager`)."""
    if _MODE.eager:
        return None
    if _MODE.stand_in is not None:
        return _MODE.stand_in
    return CudaGraph if torch.device(device).type == "cuda" else None


class CudaGraph:
    """One stage on the card: a ``torch.cuda.CUDAGraph``."""
    warmup_runs = WARMUP_RUNS

    def __init__(self, device, pool, generators):
        self._device, self._pool = device, pool
        self._graph = torch.cuda.CUDAGraph()
        for gen in generators:
            register = getattr(self._graph, "register_generator_state", None)
            if register is None:
                raise MXNetError("this torch cannot register a generator "
                                 "with a CUDA graph")
            register(gen)

    @staticmethod
    def pool(device):
        return torch.cuda.graph_pool_handle()

    @staticmethod
    @contextlib.contextmanager
    def side_stream(device):
        """Work inside runs on a new stream that waits for the current
        one, which then waits for it."""
        with torch.cuda.device(device):
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                yield
            current.wait_stream(side)

    def capture(self, fn):
        with torch.cuda.device(self._device):
            with torch.cuda.graph(self._graph, pool=self._pool):
                return fn()

    def replay(self):
        self._graph.replay()


def _ident(t):
    return (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())


def _fill(static, x):
    """Copy ``x`` into the static input ``static``; a host tensor goes to
    the card through pinned memory, so the copy does not wait for the
    card (the pinned block is reused only once the copy has run)."""
    if x.device.type == "cpu" and static.device.type == "cuda":
        static.copy_(x.pin_memory(), non_blocking=True)
    else:
        static.copy_(x)


class Program:
    """One captured step: ``stages`` (callables of their static inputs
    returning a list of tensors) captured in order, sharing one memory
    pool.  ``inputs`` are the first stage's inputs, copied into its
    static buffers; each later stage's static inputs are zeros like the
    outputs of the stage before it (a backward's output gradients).
    ``buffers`` are the tensors the stages read or write in place,
    ``generators`` the ``torch.Generator`` objects they draw from."""

    def __init__(self, name, graph_class, device, stages, inputs, buffers,
                 generators=()):
        self.name = name
        self._stages = list(stages)
        self._buffers = list(buffers)
        self._idents = [_ident(b) for b in self._buffers]
        self._gens = list(generators)
        n = len(self._stages)
        with torch.no_grad():
            self._static = [[torch.empty(x.shape, dtype=x.dtype,
                                         device=device) for x in inputs]]
            for s, x in zip(self._static[0], inputs):
                _fill(s, x)
        self._static += [None] * (n - 1)
        self._outs, self._deltas = [None] * n, [None] * n
        self.replays = [0] * n
        self._capture(graph_class, device)

    def _run(self, i, stage):
        outs = list(stage(*self._static[i]))
        if i + 1 < len(self._static) and self._static[i + 1] is None:
            self._static[i + 1] = [torch.zeros_like(o.detach())
                                   for o in outs]
        return outs

    def _capture(self, graph_class, device):
        # a graph destroyed while another one captures breaks that capture
        # (CUDA refuses the destruction then): dead programs held in
        # reference cycles are collected now, and the collector waits
        # until the capture is over
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            self._capture_stages(graph_class, device)
        finally:
            if collecting:
                gc.enable()

    def _capture_stages(self, graph_class, device):
        start = profiler.counters()
        with torch.no_grad():
            saved = [b.clone() for b in self._buffers]
        gen_states = [g.get_state() for g in self._gens]
        pool = graph_class.pool(device)
        self._graphs = [graph_class(device, pool, self._gens)
                        for _ in self._stages]
        try:
            if graph_class.warmup_runs:
                with graph_class.side_stream(device):
                    for _ in range(graph_class.warmup_runs):
                        for i, stage in enumerate(self._stages):
                            self._run(i, stage)
                for g, st in zip(self._gens, gen_states):
                    g.set_state(st)
            start = profiler.counters()
            for i, (stage, graph) in enumerate(zip(self._stages,
                                                   self._graphs)):
                before = profiler.counters()
                self._outs[i] = [o.detach() for o in graph.capture(
                    functools.partial(self._run, i, stage))]
                delta = profiler._delta(before, profiler.counters())
                delta["graph_replays"] = delta.get("graph_replays", 0) + 1
                delta["program_calls"] = delta.get("program_calls", 0) + 1
                self._deltas[i] = delta
        except Exception as e:
            self._graphs = None
            raise MXNetError("capturing the step %s as a CUDA graph failed: "
                             "%s: %s" % (self.name, type(e).__name__, e)) \
                from e
        finally:
            # the values are the ones autograd saw: through ``.data`` the
            # restore leaves each version counter as it was, so a recorded
            # graph that saved a buffer before this capture (an earlier
            # call's, or the user's own ops) still runs its backward
            with torch.no_grad():
                for b, s in zip(self._buffers, saved):
                    b.data.copy_(s)
            for g, st in zip(self._gens, gen_states):
                g.set_state(st)
            profiler._restore(start)
        profiler.bump("graph_captures", len(self._graphs))
        # a replay needs only the graphs; the stage callables may refer
        # back to the step that holds this program
        self._stages = None

    def matches(self, buffers, generators=()):
        """Whether ``buffers`` and ``generators`` are the ones captured:
        the same tensors, or tensors at the same addresses with the same
        shapes, dtypes and strides."""
        if len(buffers) != len(self._buffers) \
                or len(generators) != len(self._gens) \
                or any(a is not b for a, b in zip(generators, self._gens)):
            return False
        return all(cur is cap or _ident(cur) == ident for cur, cap, ident
                   in zip(buffers, self._buffers, self._idents))

    def replay(self, stage=0, inputs=(), clone=True):
        """Copy ``inputs`` into the stage's static inputs, replay its graph
        and return its outputs: clones, or with ``clone=False`` the static
        tensors themselves (the next replay overwrites them)."""
        with torch.no_grad():
            for s, x in zip(self._static[stage], inputs):
                _fill(s, x)
            before = profiler.counters()
            self._graphs[stage].replay()
            profiler._restore(before, self._deltas[stage])
            self.replays[stage] += 1
            outs = self._outs[stage]
            return [o.clone() for o in outs] if clone else list(outs)


class StepCache:
    """The programs of one step by key, at most ``MAX_PROGRAMS``, the least
    recently used dropped first."""

    def __init__(self, name):
        self.name = name
        self._programs = OrderedDict()
        self._families = {}  # family -> the key of its one program

    def __len__(self):
        return len(self._programs)

    def program(self, key, graph_class, device, stages, inputs, buffers,
                generators=(), family=None):
        """The program of ``key`` (with the inputs' shapes, dtypes and
        devices), captured now if it is new or its buffers moved;
        ``stages`` is called only then, to build the stage callables.  A
        ``family`` holds one program: a key whose host floats a capture
        froze (``optimizer.TracedHyper``) replaces the family's last one
        rather than adding to the cache."""
        key = (key, tuple((tuple(x.shape), x.dtype, x.device)
                          for x in inputs))
        prog = self._programs.pop(key, None)
        if prog is not None and not prog.matches(buffers, generators):
            prog = None
        if prog is None:
            if family is not None:
                self._programs.pop(self._families.pop(family, None), None)
            while len(self._programs) >= MAX_PROGRAMS:
                self._programs.popitem(last=False)
            prog = Program(self.name, graph_class, device, stages(), inputs,
                           buffers, generators)
        if family is not None:
            self._families[family] = key
        self._programs[key] = prog
        return prog
