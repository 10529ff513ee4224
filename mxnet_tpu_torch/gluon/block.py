"""Gluon ``Block``, ``HybridBlock`` and ``SymbolBlock``.

Counterpart of ``mxnet_tpu/gluon/block.py`` (name scopes ``:42-82``,
``Block`` ``:111``, ``HybridBlock`` ``:210``, its ``infer_shape``
``:250`` and ``forward`` ``:280``, ``_CachedOp`` ``:303-441``,
``SymbolBlock`` ``:476-518``).  A HybridBlock's ``hybrid_forward`` runs
on NDArrays through ``nd`` (the imperative path) or on Symbols through
``sym`` (``net(sym.var("data"))`` lowers the network to a graph, as
``Module`` takes it).  Deferred parameter shapes are filled in by
symbolic shape inference on the first input.

``hybridize()`` makes the block run through a ``_CachedOp``: on the first
call for a given signature (the inputs' shapes, dtypes and devices, and
the training mode) it traces ``hybrid_forward`` with ``F = sym`` into one
Symbol, and every call after that replays the cached graph through
``executor._run_graph`` (the path ``module.CachedTrainStep`` takes), with
the Parameters' tensors as the leaves of torch's autograd: under
``autograd.record()`` a ``backward`` reaches their gradient buffers, and
a training call writes the BatchNorm moving statistics back.
``hybridize()``, ``cast()`` and ``register_child()`` drop the cache, as
in the JAX package, whose cached op is one ``jax.jit`` program a block;
:func:`trace_count` counts the traces.  A ``SymbolBlock`` runs a given
Symbol the same way.
"""
from __future__ import annotations

import threading

import torch

from .. import ndarray as nd
from ..ndarray import NDArray
from ..ndarray.ndarray import _owned
from .. import symbol as _sym
from ..symbol import Symbol
from .. import autograd
from .. import name as _name
from .. import random as _random
from .. import capture
from .. import profiler
from ..base import MXNetError
from ..executor import _run_graph
from ..symbol.symbol import _topo
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "SymbolBlock", "trace_count",
           "reset_trace_count"]

_traces = 0


def trace_count():
    """Graphs traced by hybridized blocks since the last
    :func:`reset_trace_count`: one per block and signature."""
    return _traces


def reset_trace_count():
    global _traces
    _traces = 0


class _BlockScope:
    """Name manager of Block construction: a child made inside a block's
    ``name_scope()`` takes the prefix ``<parent prefix><alias><n>_``,
    counted per alias in that scope; a top-level block counts in the
    symbol ``NameManager``."""
    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _name.current().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        _BlockScope._current.value = self._old_scope


def _flatten(args):
    """Nested lists of NDArrays/Symbols -> (flat list, format tree)."""
    if not isinstance(args, (list, tuple)):
        return [args], 0
    flat, fmts = [], []
    for a in args:
        f, fmt = _flatten(a)
        flat.extend(f)
        fmts.append(fmt)
    return flat, fmts


def _regroup(flat, fmt):
    if isinstance(fmt, int):
        return flat[0], flat[1:]
    ret = []
    for f in fmt:
        r, flat = _regroup(flat, f)
        ret.append(r)
    return ret, flat


class Block:
    """Base of every layer and model: children assigned as attributes are
    registered, and ``collect_params`` walks the tree."""

    def __init__(self, prefix=None, params=None):
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = []

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            self.register_child(value)
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self):
        """A ParameterDict of this block's and its children's params."""
        ret = ParameterDict(self._params.prefix)
        ret.update(self.params)
        for child in self._children:
            ret.update(child.collect_params())
        return ret

    def save_params(self, filename):
        """Write the parameters to ``filename``, named without this block's
        prefix (reference ``gluon/block.py:165``)."""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """Set the parameters from a :meth:`save_params` file, in place: a
        hybridized block's captured programs replay on the new values."""
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra, self.prefix)

    def register_child(self, block):
        self._children.append(block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the current
        context; with no card that raises)."""
        if init is None:
            from .. import initializer
            init = initializer.Uniform()
        self.collect_params().initialize(init, ctx, verbose,
                                         force_reinit=force_reinit)

    def hybridize(self, active=True):
        for child in self._children:
            child.hybridize(active)

    def cast(self, dtype):
        for child in self._children:
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A Block whose ``hybrid_forward(F, x, *, <params>)`` is written
    against ``F = nd`` or ``F = sym``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._cached_op = None
        self._reg_params = {}

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, Parameter):
            assert name not in self._reg_params or \
                self._reg_params[name] is value, \
                "Overriding Parameter attribute %s is not allowed." % name
            self._reg_params[name] = value

    def register_child(self, block):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s "
                "has type %s." % (block, type(block)))
        super().register_child(block)
        self._cached_op = None

    def hybridize(self, active=True):
        self._active = active
        self._cached_op = None
        super().hybridize(active)

    def cast(self, dtype):
        self._cached_op = None
        super().cast(dtype)

    def _trace(self, *args):
        """``hybrid_forward`` on Symbols ``data0``, ``data1``, ... standing
        for ``args`` (nested lists allowed): (the flat output Symbol, the
        output nesting)."""
        flat_args, in_fmt = _flatten(list(args))
        flat_vars = [_sym.var("data%d" % i) for i in range(len(flat_args))]
        arg_tree, _ = _regroup(list(flat_vars), in_fmt)
        pkw = {name: p.var() for name, p in self._reg_params.items()}
        out = self.hybrid_forward(_sym, *arg_tree, **pkw)
        flat_out, out_fmt = _flatten(out)
        return (flat_out[0] if len(flat_out) == 1
                else _sym.Group(flat_out)), out_fmt

    def infer_shape(self, *args):
        """Fill in deferred parameter shapes by symbolic shape inference on
        the shapes of ``args``."""
        with autograd.pause():
            out, _ = self._trace(*args)
        flat_args, _ = _flatten(list(args))
        self._set_inferred_shapes(out, {"data%d" % i: a
                                        for i, a in enumerate(flat_args)})

    def _set_inferred_shapes(self, out, inputs):
        """Shape inference of ``out`` from ``inputs`` ({variable name:
        NDArray}, their shapes and dtypes) into the deferred shapes."""
        params = {p.name: p for p in self.collect_params().values()}
        args, _, auxs = out._infer(
            shape_kwargs={n: a.shape for n, a in inputs.items()},
            dtype_kwargs={n: a._data.dtype for n, a in inputs.items()},
            partial=True)
        for name, st in list(zip(out.list_arguments(), args)) + \
                list(zip(out.list_auxiliary_states(), auxs)):
            if name in params and st is not None:
                params[name]._set_shape_if_deferred(tuple(st.shape))

    def _finish_deferred(self, *args):
        self.infer_shape(*args)
        for p in self.collect_params().values():
            p._finish_deferred_init()

    def forward(self, x, *args):
        if isinstance(x, NDArray):
            try:
                if self._active:
                    return self._call_cached_op(x, *args)
                params = {k: p.data(x.context)
                          for k, p in self._reg_params.items()}
            except DeferredInitializationError:
                self._finish_deferred(x, *args)
                if self._active:
                    return self._call_cached_op(x, *args)
                params = {k: p.data(x.context)
                          for k, p in self._reg_params.items()}
            return self.hybrid_forward(nd, x, *args, **params)
        if not isinstance(x, Symbol):
            raise ValueError("HybridBlock input must be NDArray or Symbol, "
                             "got %s" % type(x))
        pkw = {k: p.var() for k, p in self._reg_params.items()}
        return self.hybrid_forward(_sym, x, *args, **pkw)

    def _call_cached_op(self, *args):
        if self._cached_op is None:
            for p in self.collect_params().values():
                p._check_and_get()  # raises while an init is deferred
            self._cached_op = _CachedOp(self)
        return self._cached_op(*args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _Claim:
    """A recorded call's hold on its program's saved activations: taken
    when its forward graph replays, given up when its backward has run or
    its recording is dropped.  Until then the next recorded call of the
    same signature takes the next slot, with a program of its own."""

    def __init__(self, pending, key):
        self._pending, self._key = pending, key
        pending.add(key)

    def release(self):
        if self._key is not None:
            self._pending.discard(self._key)
            self._key = None

    __del__ = release


class _Replayed(torch.autograd.Function):
    """A recorded call of a captured ``_CachedOp``: the forward replays
    the program's forward graph, the backward its backward graph, in the
    manner of ``torch.cuda.make_graphed_callables``.  ``tensors`` are the
    Parameters' tensors and then the inputs; their gradients come back
    from the backward graph's static outputs (``autograd.backward`` copies
    them into the gradient buffers at once).  ``claim`` holds the
    program's saved activations for this call until its backward.

    A backward under ``create_graph`` (``autograd.grad(...,
    create_graph=True)``: torch runs it with grad mode on) must return
    gradients that are differentiable again, which a replayed graph's
    outputs are not.  It runs ``recompute`` instead: the block's forward
    again, eagerly, from the saved tensors, and its gradients with
    ``create_graph``; each such backward counts one
    ``create_graph_recomputes``.  A random op draws the replay's numbers
    again (the generator is set back to where the replay began, and then
    to where it left it), so the gradient is that of the forward that
    ran.  Every first-order backward replays."""

    @staticmethod
    def forward(ctx, prog, claim, recompute, n_in, *tensors):
        outs = prog.replay(0, tensors[len(tensors) - n_in:])
        ctx.prog, ctx.claim, ctx.n = prog, claim, len(tensors)
        ctx.recompute = recompute
        ctx.generation = prog.replays[0]
        ctx.save_for_backward(*tensors)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        if torch.is_grad_enabled():
            return (None,) * 4 + _Replayed._recomputed_grads(ctx, grads)
        if ctx.prog.replays[0] != ctx.generation:
            # only a second backward of a retained graph gets here
            raise MXNetError(
                "%s: the captured forward was replayed again before this "
                "backward, which needs the activations it saved"
                % ctx.prog.name)
        got = ctx.prog.replay(1, grads, clone=False)
        ctx.claim.release()
        full = [None] * ctx.n
        for pos, g in zip(ctx.prog.live["present"], got):
            full[pos] = g
        return (None,) * 4 + tuple(full)

    @staticmethod
    def _recomputed_grads(ctx, grads):
        profiler.bump("create_graph_recomputes")
        ctx.claim.release()
        tensors = ctx.saved_tensors
        pos = [i for i, t in enumerate(tensors) if t.requires_grad]
        outs = ctx.recompute(tensors)
        diff = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        got = torch.autograd.grad([o for o, _ in diff],
                                  [tensors[i] for i in pos],
                                  [g for _, g in diff], create_graph=True,
                                  allow_unused=True)
        full = [None] * ctx.n
        for i, g in zip(pos, got):
            full[i] = g
        return tuple(full)


class _CachedOp:
    """The replay of a hybridized block: one traced Symbol per signature
    (input shapes, dtypes and devices, training mode), run by
    ``executor._run_graph`` on the inputs' and the Parameters' tensors.

    Under ``autograd.record()`` the graph runs with torch's grad mode on:
    the Parameters' tensors are the leaves their ``attach_grad`` made, so
    ``backward`` writes into their gradient buffers, and inputs that came
    out of recorded ops stay connected to them.  The moving statistics
    that a training call computes (aux outputs) are written back into
    their Parameters, as the JAX package's ``_CachedOp`` does.

    On the card each signature is a captured program (``capture``), the
    JAX package's one ``jax.jit`` program a block: not recording, one
    graph (the forward and the moving statistics' write-back); recording,
    a forward graph and a backward graph behind :class:`_Replayed`, so a
    recorded call and its backward are one replay each.  A block called
    again before the backward of its last recorded call (a shared-weight
    net, an unrolled cell) takes the next slot: the k-th such call has a
    program of its own, as each call has its own ``jax.vjp`` in the JAX
    package, and the next recording reuses them.  A graph that holds a
    ``Custom`` op (user code on the host) runs eagerly on the card too,
    counted in ``host_op_programs`` (``capture.graph_for``)."""

    def __init__(self, block):
        self._block = block
        self._params = {p.name: p for p in block.collect_params().values()}
        self._graphs = {}  # signature -> (Symbol, output nesting)
        self._programs = []  # slot -> capture.StepCache
        self._pending = set()  # (signature, slot) of calls held (_Claim)
        self._draws = {}  # id(Symbol) -> whether an op of it draws
        self._host_ops = {}  # id(Symbol) -> whether it holds a Custom op
        for p in self._params.values():
            p._users.add(self)

    def _drop_programs(self):
        """Forget the captured programs (a Parameter moved:
        ``Parameter.reset_ctx``); the traced graphs stay."""
        self._programs = []

    def _graph(self, flat_in, in_fmt, train):
        key = (repr(in_fmt), train, tuple(
            (tuple(x._data.shape), x._data.dtype, x._data.device)
            for x in flat_in))
        graph = self._graphs.get(key)
        if graph is None:
            global _traces
            args, _ = _regroup(list(flat_in), in_fmt)
            with autograd.pause(train_mode=train):
                graph = self._graphs[key] = self._block._trace(*args)
            _traces += 1
        return graph

    def __call__(self, *args):
        flat_in, in_fmt = _flatten(list(args))
        train = autograd.is_training()
        symbol, out_fmt = self._graph(flat_in, in_fmt, train)
        names = [n for n in symbol.list_arguments() if n in self._params]
        ctx = flat_in[0].context
        used = [self._params[n].data(ctx) for n in names]
        aux_names = symbol.list_auxiliary_states()
        host_op = self._host_ops.get(id(symbol))
        if host_op is None:
            host_op = self._host_ops[id(symbol)] = capture.holds_host_op(
                _topo(symbol._outputs))
        graph = capture.graph_for(flat_in[0]._data.device, host_op)
        if graph is not None:
            outs = self._replay(graph, symbol, train, flat_in, names, used,
                                aux_names, ctx)
        else:
            outs = self._eager(symbol, train, flat_in, names, used,
                               aux_names, ctx)
        if autograd.is_recording():
            nds = used + flat_in
            autograd._note_inputs(nds, range(len(nds)))
        out, _ = _regroup([NDArray(o, ctx) for o in outs], out_fmt)
        return out

    def _eager(self, symbol, train, flat_in, names, used, aux_names, ctx):
        arg_vals = {"data%d" % i: x._data for i, x in enumerate(flat_in)}
        arg_vals.update(zip(names, (a._data for a in used)))
        aux_vals = {n: self._params[n].data()._data for n in aux_names}
        gen = _random.generator(ctx)
        if autograd.is_recording():
            with torch.enable_grad():
                outs, new_aux = _run_graph(symbol, arg_vals, aux_vals,
                                           train, gen)
        else:
            with torch.no_grad():
                outs, new_aux = _run_graph(symbol, arg_vals, aux_vals,
                                           train, gen)
                outs = [_owned(o, [a._data for a in used + flat_in])
                        for o in outs]
        for name, value in new_aux.items():
            if value is not aux_vals[name]:
                self._params[name].data()._set_data(value)
        return outs

    def _replay(self, graph, symbol, train, flat_in, names, used, aux_names,
                ctx):
        """The call as one replay of the signature's captured program (and,
        recording, its backward as one more)."""
        params = [a._data for a in used]
        xs = [x._data for x in flat_in]
        # recording with nothing to differentiate is a forward, as eagerly
        recording = autograd.is_recording() and any(
            t.requires_grad for t in params + xs)
        auxs = [self._params[n].data()._data for n in aux_names]
        gen = _random.generator(ctx)
        draws = self._draws.get(id(symbol))
        if draws is None:
            draws = self._draws[id(symbol)] = any(
                n.op is not None and n.op.needs_rng
                for n in _topo(symbol._outputs))
        need = tuple(t.requires_grad for t in params + xs) if recording \
            else None
        live = {}

        def run(leaves, inputs, grad_mode):
            arg_vals = {"data%d" % i: x for i, x in enumerate(inputs)}
            arg_vals.update(zip(names, leaves))
            aux_vals = dict(zip(aux_names, auxs))
            with torch.set_grad_enabled(grad_mode):
                outs, new_aux = _run_graph(symbol, arg_vals, aux_vals,
                                           train, gen)
            with torch.no_grad():
                moved = [(aux_vals[n], v) for n, v in new_aux.items()
                         if v is not aux_vals[n]]
                if moved:
                    torch._foreach_copy_([d for d, _ in moved],
                                         [v for _, v in moved])
            return outs

        def forward(*inputs):
            return [o.detach() for o in run(params, inputs, False)]

        def recorded_forward(*inputs):
            wrt = [t.detach().requires_grad_(r)
                   for t, r in zip(params + list(inputs), need)]
            outs = run(wrt[:len(params)], wrt[len(params):], True)
            live["outs"] = outs
            live["wrt"] = [(i, t) for i, t in enumerate(wrt) if need[i]]
            return [o.detach() for o in outs]

        def backward(*grads):
            outs, wrt = live["outs"], live["wrt"]
            diff = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            got = torch.autograd.grad([o for o, _ in diff],
                                      [t for _, t in wrt],
                                      [g for _, g in diff], allow_unused=True)
            live["present"] = [i for (i, _), g in zip(wrt, got)
                               if g is not None]
            return [g for g in got if g is not None]

        stages = (lambda: [recorded_forward, backward]) if recording \
            else (lambda: [forward])
        sig = (id(symbol), train, need)
        slot = 0
        if recording:
            shapes = tuple((x.shape, x.dtype, x.device) for x in xs)
            while (sig, shapes, slot) in self._pending:
                slot += 1
        while len(self._programs) <= slot:
            self._programs.append(capture.StepCache("_CachedOp(%s) call %d"
                                                    % (self._block.name,
                                                       len(self._programs))))
        prog = self._programs[slot].program(
            sig, graph, xs[0].device, stages, xs, params + auxs,
            [gen] if draws else [])
        if not recording:
            return prog.replay(0, xs)
        if not hasattr(prog, "live"):  # captured just now, by these stages
            prog.live = live

        # where the replay below begins drawing, for ``recompute``
        drawn_from = gen.get_state() if draws else None

        def recompute(tensors):
            """The call's outputs again, eagerly, from ``tensors`` (the
            Parameters' and the inputs'), drawing what the replay drew;
            the moving statistics are left as the replay wrote them, and
            the generator where the replay left it."""
            arg_vals = {"data%d" % i: x
                        for i, x in enumerate(tensors[len(params):])}
            arg_vals.update(zip(names, tensors[:len(params)]))
            if drawn_from is None:
                return _run_graph(symbol, arg_vals,
                                  dict(zip(aux_names, auxs)), train, gen)[0]
            after = gen.get_state()
            gen.set_state(drawn_from)
            try:
                return _run_graph(symbol, arg_vals,
                                  dict(zip(aux_names, auxs)), train, gen)[0]
            finally:
                gen.set_state(after)
        return _Replayed.apply(prog, _Claim(self._pending,
                                            (sig, shapes, slot)),
                               recompute, len(xs), *(params + xs))


class SymbolBlock(HybridBlock):
    """A block that runs a given Symbol (reference ``:476-518``): its
    arguments other than ``inputs`` become Parameters (shared with
    ``params`` where it names them), its aux states Parameters without
    gradients.  Its forward on NDArrays is the cached-graph replay of a
    hybridized block, differentiable through the Parameters; on Symbols
    it composes the graph."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        self._prefix = ""
        self._params = ParameterDict("", params)
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        out = _sym.Group(outputs) if isinstance(outputs, (list, tuple)) \
            else outputs
        input_names = set(i.name for i in inputs)
        for name in out.list_arguments():
            if name not in input_names:
                self.params.get(name, allow_deferred_init=True)
        for name in out.list_auxiliary_states():
            self.params.get(name, grad_req="null", allow_deferred_init=True)
        self._out = out
        self._input_names = [i.name for i in inputs]
        self._n_out = len(out.list_outputs())
        self._active = True

    def hybridize(self, active=True):
        """A SymbolBlock always runs its graph; only the cache drops."""
        self._cached_op = None

    def _trace(self, *args):
        """The given Symbol, its inputs renamed ``data0``, ``data1``, ..."""
        flat_args, _ = _flatten(list(args))
        if len(flat_args) != len(self._input_names):
            raise ValueError("SymbolBlock takes %d inputs (%s), got %d"
                             % (len(self._input_names), self._input_names,
                                len(flat_args)))
        rename = {n: _sym.var("data%d" % i)
                  for i, n in enumerate(self._input_names)}
        out = self._compose(rename)
        return out, (0 if self._n_out == 1 else list(range(self._n_out)))

    def _compose(self, inputs):
        """The Symbol with its input variables replaced by ``inputs``
        ({name: Symbol})."""
        from ..symbol.symbol import SymNode, _topo
        new = {}
        for node in _topo(self._out._outputs):
            if node.op is None:
                if node.name in inputs:
                    new[id(node)] = inputs[node.name]._outputs[0][0]
                else:
                    new[id(node)] = node
                continue
            new[id(node)] = SymNode(node.op, node.name, node.attrs,
                                    [(new[id(n)], i) for n, i in node.inputs])
        return Symbol([(new[id(n)], i) for n, i in self._out._outputs])

    def infer_shape(self, *args):
        flat_args, _ = _flatten(list(args))
        self._set_inferred_shapes(self._out,
                                  dict(zip(self._input_names, flat_args)))

    def forward(self, x, *args):
        if isinstance(x, Symbol):
            return self._compose(dict(zip(self._input_names, (x,) + args)))
        return super().forward(x, *args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
