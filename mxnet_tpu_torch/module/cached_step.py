"""``CachedTrainStep``: forward, backward and the update of every
parameter in one call per step.

Counterpart of ``mxnet_tpu/module/cached_step.py:82``, where the step is
one jitted program that differentiates the bound graph and updates each
parameter inside it, its buffers donated and its lr, wd and t traced
(``:126``, ``:181-185``).  The step runs the graph under autograd,
``autograd.grad`` seeds every output with ones (``SoftmaxOutput``'s
semantic backward ignores the seed), the optimizer's ``fused_update``
updates all the parameters and their states with multi-tensor ops, and
the BatchNorm moving statistics are written back.  The gradients go from
autograd into the update and are never copied into the executor's
``grad_dict``.  Learning rates, weight decays and update counts per
parameter follow the optimizer's rules and count as the two-call path
counts them, on the host.

On the card the step is one captured program (``capture``): replayed
once a step over the executor's arguments and moving statistics and the
optimizer's states, in place, with the hyper-parameters in a device
tensor (``optimizer.TracedHyper``) that the host fills before each
replay, so a learning-rate schedule never recaptures.  A CSR argument
(a ``LibSVMIter`` batch) is read from its capacity buffers
(``ndarray.sparse``): the program is keyed on the capacity, one such
program held, and a batch that outgrows the buffers captures again.  On
the CPU, and inside ``capture.eager()``, and where its Symbol holds a
``Custom`` op (``capture.graph_for``), it runs eagerly.  Its programs
capture into the ``pool`` it is given (``capture.MemoryPool``, one for
all the steps of a ``Module`` or a ``BucketingModule``), and
:meth:`capture` captures the step without taking it.  ``MXNET_MODULE_FUSED_STEP=0`` turns the
fused step off.
"""
from __future__ import annotations

import os

import torch

from ..ndarray import NDArray
from ..ndarray import sparse as _sparse
from .. import capture, profiler
from .. import random as _random
from ..executor import _run_graph, load_into
from ..optimizer import TracedHyper, _state_raw, _state_tensors
from ..symbol.symbol import _topo

__all__ = ["CachedTrainStep", "fused_step_enabled"]


def fused_step_enabled():
    """False when ``MXNET_MODULE_FUSED_STEP`` is 0/false/off/no."""
    return os.environ.get("MXNET_MODULE_FUSED_STEP", "1").strip().lower() \
        not in ("0", "false", "off", "no")


class CachedTrainStep:
    """The train step bound to (executor, updater, parameter names)."""

    def __init__(self, executor, updater, param_names, pool=None):
        self._exec = executor
        self._updater = updater
        self._opt = updater.optimizer
        if not self._opt.supports_fused():
            raise ValueError("%s has no fused update"
                             % type(self._opt).__name__)
        # the executor's grad-bearing arguments, in the module's order, so
        # that the optimizer's indices are the two-call path's
        grad_set = set(executor._grad_names)
        self._pnames = [n for n in param_names if n in grad_set]
        if set(self._pnames) != grad_set:
            raise ValueError("fused step needs grads on params only")
        self._pidx = {n: i for i, n in enumerate(param_names)}
        self._programs = capture.StepCache("CachedTrainStep", pool)
        self._draws = self._opt.draws_random or any(
            n.op is not None and n.op.needs_rng
            for n in _topo(executor._symbol._outputs))
        self._host_op = capture.holds_host_op(_topo(executor._symbol._outputs))

    def _ensure_states(self):
        """Optimizer state through the Updater, as the two-call path makes
        it (and moves a loaded one)."""
        for name in self._pnames:
            self._updater.state_for(self._pidx[name],
                                    self._exec.arg_dict[name])

    def run(self, feed):
        """One step; ``feed`` maps data and label names to NDArrays.
        Returns the outputs, also left in ``executor.outputs``."""
        ex = self._exec
        for k, v in feed.items():
            if k in ex.arg_dict:
                load_into(ex.arg_dict[k], v)
        self._ensure_states()
        lrs, wds, counts = self._hyper()
        states = self._states()
        graph = capture.graph_for(ex._ctx.torch_device, self._host_op)
        if graph is None:
            profiler.bump("program_calls")
            outs = self._step(states, dict(lrs=lrs, wds=wds, counts=counts))
        else:
            outs = self._replay(graph, states, lrs, wds, counts)
        ex._train = None
        ex._outputs = [NDArray(o, ex._ctx) for o in outs]
        return ex._outputs

    def capture(self):
        """Capture the step's program without taking a step (the buffers,
        the update counts and the generators are left as they were);
        nothing where the step runs eagerly."""
        graph = None if self._host_op else capture.graph_for(
            self._exec._ctx.torch_device)
        if graph is None:
            return
        self._ensure_states()
        opt = self._opt
        held = dict(opt._index_update_count), opt.num_update
        try:
            lrs, wds, counts = self._hyper()
        finally:
            opt._index_update_count, opt.num_update = held
        self._program(graph, self._states(), lrs, wds, counts)

    def _hyper(self):
        """Count this step's update and return its lrs, wds and counts."""
        opt = self._opt
        lrs, wds, counts = [], [], []
        for name in self._pnames:
            idx = self._pidx[name]
            opt._update_count(idx)
            lrs.append(opt._get_lr(idx))
            wds.append(opt._get_wd(idx))
            counts.append(opt._index_update_count[idx])
        return lrs, wds, counts

    def _states(self):
        return [_state_raw(self._updater.states[self._pidx[n]])
                for n in self._pnames]

    def _step(self, states, hyper):
        """Forward, gradients, ``fused_update(**hyper)`` and the moving
        statistics' write-back, on the executor's tensors in place;
        returns the outputs."""
        ex, opt = self._exec, self._opt
        arg_vals = {n: _sparse.raw(a) for n, a in ex.arg_dict.items()}
        weights = [arg_vals[n] for n in self._pnames]
        leaves = [w.detach().requires_grad_(True) for w in weights]
        arg_vals.update(zip(self._pnames, leaves))
        aux_vals = {n: a._data for n, a in ex.aux_dict.items()}
        with torch.enable_grad():
            outs, new_aux = _run_graph(ex._symbol, arg_vals, aux_vals, True,
                                       _random.generator(ex._ctx))
        diff = [o for o in outs if o.requires_grad]
        grads = torch.autograd.grad(diff, leaves,
                                    [torch.ones_like(o) for o in diff],
                                    allow_unused=True)
        with torch.no_grad():
            # a parameter that reaches no output has a zero gradient
            grads = [torch.zeros_like(w) if g is None else g
                     for w, g in zip(weights, grads)]
            opt.fused_update(weights, grads, states, **hyper)
            moved = [(aux_vals[n], v) for n, v in new_aux.items()
                     if v is not aux_vals[n]]
            if moved:
                torch._foreach_copy_([d for d, _ in moved],
                                     [v for _, v in moved])
        return [o.detach() for o in outs]

    def _program(self, graph, states, lrs, wds, counts):
        """The step's program, captured now where it is new, and the
        hyper-parameter values to replay it with."""
        ex = self._exec
        hyper = TracedHyper(self._opt, lrs, wds, counts)
        buffers = [t for a in ex.arg_dict.values()
                   for t in _sparse.tensors(a)] \
            + [a._data for a in ex.aux_dict.values()] + _state_tensors(states)
        gens = [_random.generator(ex._ctx)] if self._draws else []
        caps = _sparse.capacities(ex.arg_dict.values())
        family = hyper.family if not caps else ("csr", hyper.family)
        prog = self._programs.program(
            ("module_step", hyper.key, caps), graph, ex._ctx.torch_device,
            lambda: [lambda values: self._step(states, hyper.unpack(values))],
            [hyper.values], buffers, gens, family=family)
        return prog, hyper.values

    def _replay(self, graph, states, lrs, wds, counts):
        """The step as one replay of its captured program; the outputs are
        cloned out of its memory pool."""
        prog, values = self._program(graph, states, lrs, wds, counts)
        return prog.replay(0, [values])
