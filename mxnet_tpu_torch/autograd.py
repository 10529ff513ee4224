"""Define-by-run autograd: record/pause scopes and backward, on top of
torch's own autograd.

Counterpart of ``mxnet_tpu/autograd.py:59-264``, with ``grad``
(``:333``) and ``get_symbol`` (``:349``).  The JAX package keeps a
tape of ``jax.vjp`` closures; here an op invoked inside ``record()`` runs
with torch's grad mode on, so the graph lives in the output tensors'
``grad_fn``.  ``attach_grad``/``mark_variables`` make an NDArray's tensor
a leaf that requires grad; :func:`backward` asks torch for the gradients
of the marked variables that the recorded ops read, and writes each into
the variable's gradient buffer in place, by its ``grad_req``:
``write`` copies, ``add`` accumulates, ``null`` leaves it as it is.
:func:`grad` returns the gradients instead and writes no buffer; with
``create_graph`` they are differentiable again (torch's double
backward).  :func:`get_symbol` rebuilds a Symbol from what the recorded
ops kept on their outputs (``ndarray.invoke``).
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "mark_variables", "backward", "grad", "get_symbol",
           "set_recording", "set_training"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        self.variables = {}  # id -> marked NDArray read by a recorded op


_STATE = _State()


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def set_recording(flag):
    prev = _STATE.recording
    _STATE.recording = bool(flag)
    return prev


def set_training(flag):
    prev = _STATE.training
    _STATE.training = bool(flag)
    return prev


class _RecordingScope:
    def __init__(self, recording, training):
        self._rec, self._train = recording, training
        self._prev = []

    def __enter__(self):
        self._prev.append((_STATE.recording, _STATE.training))
        if self._rec is not None:
            if self._rec and not _STATE.recording:
                _STATE.variables = {}  # fresh outermost recording session
            _STATE.recording = self._rec
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training = self._prev.pop()

    def __call__(self, fn):
        def wrapped(*a, **kw):
            with self.__class__(self._rec, self._train):
                return fn(*a, **kw)
        return wrapped


def record(train_mode=True):  # noqa: A002 - reference name
    return _RecordingScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingScope(False, train_mode)


def train_mode():
    return _RecordingScope(None, True)


def predict_mode():
    return _RecordingScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers: each variable's tensor becomes a leaf that
    requires grad, and ``gradients[i]`` receives its gradient."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, not %r"
                             % (req,))
        v._data = v._data.detach().requires_grad_(True)
        v._grad = g
        v._grad_req = req
        v._marked = True


def _note_inputs(inputs, diff_idx):
    """Remember the marked variables a recorded op reads."""
    for i in diff_idx:
        if inputs[i]._marked:
            _STATE.variables[id(inputs[i])] = inputs[i]


def _write_grads(variables, grads):
    """Write each gradient into its variable's buffer by its ``grad_req``,
    all ``write``s in one multi-tensor copy and all ``add``s in one
    multi-tensor add, and mark each fresh for ``Trainer.step``'s
    stale-gradient check (reference ``mxnet_tpu/autograd.py:158``); a
    variable that got no gradient keeps its buffer and its staleness."""
    by_req = {"write": ([], []), "add": ([], [])}
    for v, g in zip(variables, grads):
        if g is None or v._grad is None or v._grad_req == "null":
            continue
        dst, src = by_req[v._grad_req]
        dst.append(v._grad._data)
        src.append(g)
        v._fresh_grad = True
    with torch.no_grad():
        if by_req["write"][0]:
            torch._foreach_copy_(*by_req["write"])
        if by_req["add"][0]:
            torch._foreach_add_(*by_req["add"])


def _heads_and_seeds(heads, head_grads):
    """The heads' tensors and their seeds (ones where no head gradient
    is given); raises for a head outside every recorded graph."""
    heads = heads if isinstance(heads, (list, tuple)) else [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    outs, seeds = [], []
    for h, hg in zip(heads, head_grads):
        if not h._data.requires_grad:
            raise MXNetError(
                "cannot differentiate a head that is not in a recorded "
                "computational graph (did you run inside autograd.record()?)")
        outs.append(h._data)
        seeds.append(torch.ones_like(h._data) if hg is None else hg._data)
    return heads, outs, seeds


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into the attached buffers of the marked
    variables they depend on (reference ``autograd.backward``)."""
    heads, outs, seeds = _heads_and_seeds(heads, head_grads)
    variables = dict(_STATE.variables)
    for h in heads:
        if h._marked:
            variables[id(h)] = h
    variables = list(variables.values())
    if not variables:
        return
    grads = torch.autograd.grad(outs, [v._data for v in variables], seeds,
                                retain_graph=retain_graph, allow_unused=True)
    _write_grads(variables, grads)
    if not retain_graph:
        _STATE.variables = {}


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` (marked
    NDArrays), as new NDArrays; no gradient buffer is written.  With
    ``create_graph`` the gradients are themselves differentiable: ops on
    them inside ``record()`` reach the variables (and every other marked
    array the heads depend on) in a later ``backward``.
    ``retain_graph`` defaults to ``create_graph``."""
    variables = variables if isinstance(variables, (list, tuple)) \
        else [variables]
    if retain_graph is None:
        retain_graph = create_graph
    _, outs, seeds = _heads_and_seeds(heads, head_grads)
    if not all(v._data.requires_grad for v in variables):
        raise MXNetError("one of the requested variables is not part of the "
                         "recorded graph")
    grads = torch.autograd.grad(outs, [v._data for v in variables], seeds,
                                retain_graph=retain_graph,
                                create_graph=create_graph, allow_unused=True)
    if any(g is None for g in grads):
        raise MXNetError("one of the requested variables is not part of the "
                         "recorded graph")
    from .ndarray import NDArray
    return [NDArray(g if create_graph else g.detach(), v.context)
            for g, v in zip(grads, variables)]


def get_symbol(x):
    """A Symbol of the recorded computation that made ``x``: its ops with
    their attributes, each input that no recorded op made a variable
    (its ``name``, else ``var<n>``)."""
    from .symbol import Symbol, var
    if getattr(x, "_node", None) is None:
        raise MXNetError("array is not an output of a recorded computation")
    memo = {}

    def build(item):
        # item: an output's node (a tuple), or an array no recorded op made
        key = id(item)
        if key in memo:
            return memo[key]
        if not isinstance(item, tuple):
            s = var(item.name or "var%d" % len(memo))
        else:
            op, attrs, inputs, index, count = item
            s = Symbol._from_op(op.name, [build(i) for i in inputs],
                                dict(attrs))
            if count > 1:
                s = s[index]
        memo[key] = s
        return s

    return build(x._node)
