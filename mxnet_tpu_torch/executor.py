"""Executor: a bound symbolic graph over torch tensors, replayed on the
card as captured programs.

Counterpart of ``mxnet_tpu/executor.py:55-513``.  The JAX package traces
the graph into jitted programs (``:139-181``): ``_eval_jit`` and
``_train_jit`` for a forward, ``_fwd_train_jit`` and ``_bwd_jit`` for a
training forward and its backward (the vjp's residuals carried between
them), ``_fwd_bwd_jit`` and ``_fwd_bwd_ones_jit`` for ``forward_backward``
as one program (``:436-475``).  Here ``_run_graph`` walks the graph in
topological order, calling each op on the bound tensors, a training
forward under torch's grad mode, and the gradients come from
``torch.autograd.grad``.  On the card each entry point is a captured
program (``capture``), the counterpart of those jits:

- ``forward(is_train=False)``, and a training forward with nothing to
  differentiate: one program;
- ``forward(is_train=True)`` and ``backward``: the two stages of one
  program.  ``forward`` replays the first; ``backward`` the second, with
  the output gradients as its static inputs.  The forward's saved
  activations wait in the program's own memory pool for its backward;
- ``forward_backward``: one program, with ones as the output gradients,
  or with the given ``out_grads`` as its static inputs.

Gradients are written into the existing ``grad_dict`` NDArrays in place
inside the program (``add`` accumulates there), so an optimizer that holds
them sees every step's values; aux states (moving statistics) are written
back the same way.  Random draws use the context's generator, registered
with the program.  Outputs are cloned on the way out.  A batch fed through
``forward(**kwargs)`` or the executor group is copied into the bound
arrays (:func:`load_into`; a CSR into its capacity buffers,
``ndarray.sparse``), so a program replays over the same addresses every
step; a buffer that moved (a CSR that outgrew its capacity, an array
rebound at another shape) captures the program again, counted in
``graph_captures``.  The single-stage programs capture into
``graph_pool`` (a ``capture.MemoryPool``; a ``Module`` hands its
executors its own).

On the CPU, inside ``capture.eager()``, where the Symbol holds a
``Custom`` op (``capture.graph_for``), under an active monitor and with
``group2ctx``, every entry point runs the graph eagerly: ``backward``
then differentiates the graph the training forward recorded.  A monitor
(``set_monitor_callback``) sees every node's outputs by name; with
``group2ctx`` each op runs on the context of its ``__ctx_group__``
attribute (reference ``graph_executor.cc`` PlaceDevice), its inputs
moved there, the outputs brought back to the executor's context.

A variable whose ``__storage_type__`` is ``csr`` (``sym.var(stype=
"csr")``) binds an empty CSR, never a dense array of its shape: at
avazu-app's width one dense batch is 32.8 GB.  The JAX executor ignores
the attribute and binds dense zeros, which XLA's static shapes want.  A
CSR argument runs through the graph as its parts (``ops.sparse_dot.CSR``):
``dot`` takes them as its left operand, any other op reads the dense
view (counted in ``sparse_densify``; ``Op.operand`` decides, here and in
``ndarray.invoke``), as does an argument that takes a gradient.  Each run
reads a CSR through a new shell (``CSR.shell``), so a dense view is built
inside a captured program on every replay, never cached across batches.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import as_context
from . import capture
from . import random as _random
from .ndarray import NDArray, zeros as nd_zeros
from .ndarray import sparse as _sparse
from .ops.sparse_dot import CSR
from .symbol.symbol import _topo

__all__ = ["Executor", "load_into"]


def _run_graph(symbol, arg_vals, aux_vals, train_mode, gen, place=None,
               observe=None):
    """Run the graph on tensors: {arg name: tensor}, {aux name: tensor}
    -> (outputs, {aux name: new value}).  ``place(node)`` gives the device
    an op node runs on (its inputs moved there); ``observe(name, value)``
    sees every op output."""
    env = {}
    new_aux = {}
    for node in _topo(symbol._outputs):
        if node.op is None:
            v = (aux_vals if node.is_aux else arg_vals)[node.name]
            env[(id(node), 0)] = v.shell() if isinstance(v, CSR) else v
            continue
        ins = [node.op.operand(i, env[(id(s), oi)])
               for i, (s, oi) in enumerate(node.inputs)]
        attrs = node.attrs
        if place is not None:
            dev = place(node)
            ins = [x if x.device == dev else x.to(dev) for x in ins]
        if node.op.no_inputs and attrs.get("ctx") is None:
            attrs = dict(attrs, ctx=gen.device)
        outs = node.op.traceable(attrs, train_mode=train_mode,
                                 rng=gen if node.op.needs_rng else None)(*ins)
        for i, o in enumerate(outs):
            env[(id(node), i)] = o
            if observe is not None:
                observe(node.output_name(i) if i < node.num_outputs()
                        else "%s_aux%d" % (node.name, i), o)
        for aux_in, out_idx in node.op.aux_updates.items():
            src = node.inputs[aux_in][0] if aux_in < len(node.inputs) else None
            if src is not None and src.op is None and src.is_aux:
                new_aux[src.name] = outs[out_idx]
    return [env[(id(n), oi)] for n, oi in symbol._outputs], new_aux


def arg_zeros(stype, meta, ctx):
    """The zeros a variable binds: an empty CSR for ``stype`` ``csr``, else
    a dense array of ``meta``'s shape and dtype."""
    if stype == "csr":
        return _sparse.zeros("csr", tuple(meta.shape), ctx=ctx,
                             dtype=meta.dtype)
    return nd_zeros(tuple(meta.shape), ctx=ctx, dtype=meta.dtype)


def load_into(arr, src):
    """Copy ``src`` (an NDArray, a CSR's parts, a tensor or an array-like)
    into the bound array ``arr``, in place: a CSR into its capacity
    buffers, a dense batch of ``arr``'s shape into its tensor in its dtype
    (a host one through pinned memory).  A dense batch of another shape
    rebinds ``arr`` to a copy of it."""
    if isinstance(src, NDArray):
        src = _sparse.raw(src)
    elif not isinstance(src, (torch.Tensor, CSR)):
        src = torch.from_numpy(np.array(src))
    if isinstance(src, CSR) or isinstance(arr, _sparse.CSRNDArray):
        arr._set_data(src)
        return
    dst = arr._data
    with torch.no_grad():
        if tuple(src.shape) == tuple(dst.shape):
            capture.fill(dst, src.detach())
        else:
            arr._data = src.detach().to(dst.device, dst.dtype, copy=True)


class Executor:
    """A bound computation graph (create with ``Symbol.bind`` or
    ``Symbol.simple_bind``)."""

    def __init__(self, symbol, ctx, arg_dict, grad_dict, grad_req, aux_dict,
                 group2ctx=None):
        self._symbol = symbol
        self._ctx = as_context(ctx)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        missing = [n for n in self.arg_names if n not in arg_dict]
        if missing:
            raise MXNetError("bind: missing arguments %s" % missing)
        self.arg_dict = {n: arg_dict[n] for n in self.arg_names}
        missing = [n for n in self.aux_names if aux_dict.get(n) is None]
        if missing:
            raise MXNetError("bind: missing auxiliary states %s" % missing)
        self.aux_dict = {n: aux_dict[n] for n in self.aux_names}
        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in self.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(self.arg_names, grad_req))
        self.grad_req = {n: grad_req.get(n, "null") for n in self.arg_names}
        bad = {r for r in self.grad_req.values()} - {"write", "add", "null"}
        if bad:
            raise MXNetError("grad_req must be write, add or null, not %s"
                             % sorted(bad))
        self.grad_dict = {n: (grad_dict or {}).get(n) for n in self.arg_names}
        for n, req in self.grad_req.items():
            if req != "null" and self.grad_dict[n] is None:
                self.grad_dict[n] = nd_zeros(self.arg_dict[n].shape,
                                             ctx=self._ctx,
                                             dtype=self.arg_dict[n]._data.dtype)
        self._grad_names = [n for n in self.arg_names
                            if self.grad_req[n] != "null"]
        self._group2ctx = {g: as_context(c) for g, c in
                           (group2ctx or {}).items()}
        self._monitor = None
        nodes = _topo(symbol._outputs)
        self._draws = any(n.op is not None and n.op.needs_rng for n in nodes)
        self._host_op = capture.holds_host_op(nodes)
        self.graph_pool = capture.MemoryPool()
        self._caches = {}   # two stages or one -> capture.StepCache
        # until backward: (outputs, leaves) of an eager training forward,
        # or the captured program whose second stage is due
        self._train = None
        self._outputs = None

    # -- array views -------------------------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict[n] for n in self.arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self.aux_names]

    @property
    def outputs(self):
        if self._outputs is None:
            raise MXNetError("run forward() first")
        return self._outputs

    @property
    def output_dict(self):
        return dict(zip(self.output_names, self.outputs))

    # -- execution ---------------------------------------------------------
    def _feed(self, kwargs):
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown argument %s" % k)
            load_into(self.arg_dict[k], v)

    def _monitoring(self):
        return self._monitor is not None and getattr(
            self._monitor, "is_active", lambda: True)()

    def _graph(self):
        """The graph class the entry points capture with, or None where
        the graph runs eagerly (see the module's notes)."""
        if self._group2ctx or self._monitoring():
            return None
        return capture.graph_for(self._ctx.torch_device, self._host_op)

    def _place(self, node):
        group = node.attrs.get("__ctx_group__")
        ctx = self._group2ctx.get(group) if group else None
        return (ctx or self._ctx).torch_device

    def _run(self, is_train, grad):
        """One run of the graph on the bound arrays, the moving statistics
        written back in place: (outputs, the leaves of the arguments that
        take gradients where ``grad``)."""
        arg_vals = {n: _sparse.raw(a) for n, a in self.arg_dict.items()}
        aux_vals = {n: a._data for n, a in self.aux_dict.items()}
        leaves = None
        if grad:
            leaves = []
            for n in self._grad_names:
                v = arg_vals[n]
                v = v.shell().dense() if isinstance(v, CSR) else v
                leaves.append(v.detach().requires_grad_(True))
            arg_vals.update(zip(self._grad_names, leaves))
        observe = None
        if self._monitoring():
            def observe(name, value):
                self._monitor(name, NDArray(value.detach(), self._ctx))
        place = self._place if self._group2ctx else None
        with torch.set_grad_enabled(grad):
            outs, new_aux = _run_graph(self._symbol, arg_vals, aux_vals,
                                       is_train, _random.generator(self._ctx),
                                       place, observe)
            if place is not None:
                home = self._ctx.torch_device
                outs = [o if o.device == home else o.to(home) for o in outs]
        with torch.no_grad():
            moved = [(aux_vals[n], v) for n, v in new_aux.items()
                     if v is not aux_vals[n]]
            for dst, v in moved:
                dst.copy_(v)
        return outs, leaves

    def _differentiate(self, outs, leaves, seeds):
        """The gradients of ``outs`` seeded by ``seeds`` written into
        ``grad_dict`` (``add`` accumulates, ``write`` zeroes an argument
        that reaches no output)."""
        diff = [(o, s) for o, s in zip(outs, seeds) if o.requires_grad]
        if not diff:
            raise MXNetError("no output of the graph depends on an argument "
                             "that requires a gradient")
        grads = torch.autograd.grad([o for o, _ in diff], leaves,
                                    [s for _, s in diff], allow_unused=True)
        with torch.no_grad():
            for n, g in zip(self._grad_names, grads):
                dst = self.grad_dict[n]._data
                if g is None:
                    if self.grad_req[n] == "write":
                        dst.zero_()
                elif self.grad_req[n] == "add":
                    dst.add_(g)
                else:
                    dst.copy_(g)

    def _seeds(self, out_grads, like):
        """The output gradients: ones like ``like``, or ``out_grads``."""
        if out_grads is None:
            return [torch.ones_like(o) for o in like]
        if isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        dev = self._ctx.torch_device
        return [g._data if isinstance(g, NDArray)
                else torch.as_tensor(g, device=dev) for g in out_grads]

    def _program(self, kind, graph, stages, inputs=()):
        """The captured program of ``kind`` over the bound arrays, keyed
        also on the capacities of the CSR arguments (one such program of
        a kind is held: a CSR that outgrew its buffers replaces it)."""
        staged = kind == "train"
        cache = self._caches.get(staged)
        if cache is None:
            cache = self._caches[staged] = capture.StepCache(
                "Executor." + ("forward/backward" if staged else kind),
                None if staged else self.graph_pool)
        caps = _sparse.capacities(self.arg_dict.values())
        buffers = [t for a in self.arg_dict.values()
                   for t in _sparse.tensors(a)] \
            + [a._data for a in self.aux_dict.values()] \
            + [self.grad_dict[n]._data for n in self._grad_names]
        gens = [_random.generator(self._ctx)] if self._draws else []
        return cache.program((kind, caps), graph, self._ctx.torch_device,
                             stages, list(inputs), buffers, gens,
                             family=(kind, "csr") if caps else None)

    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` are copied into ``arg_dict`` first.
        A training forward keeps what ``backward`` needs."""
        self._feed(kwargs)
        return self._forward(is_train, self._graph())

    def _forward(self, is_train, graph):
        self._train = None
        train = is_train and bool(self._grad_names)
        if graph is None:
            outs, leaves = self._run(is_train, train)
            if train:
                self._train = (outs, leaves)
            outs = [o.detach() for o in outs]
        elif train:
            prog = self._train_program(graph)
            outs = prog.replay(0)
            self._train = prog
        else:
            prog = self._program(
                "forward" if is_train else "eval", graph,
                lambda: [lambda: [o.detach()
                                  for o in self._run(is_train, False)[0]]])
            outs = prog.replay(0)
        self._outputs = [NDArray(o, self._ctx) for o in outs]
        return self._outputs

    def _train_program(self, graph):
        """The training forward and its backward as two stages of one
        program; ``live`` keeps the forward's outputs and leaves for the
        backward stage, and whether an output is differentiable."""
        live = {}

        def fwd():
            outs, leaves = self._run(True, True)
            live.update(outs=outs, leaves=leaves,
                        diff=any(o.requires_grad for o in outs))
            return [o.detach() for o in outs]

        def bwd(*seeds):
            if live["diff"]:
                self._differentiate(live.pop("outs"), live.pop("leaves"),
                                    seeds)
            return []
        prog = self._program("train", graph, lambda: [fwd, bwd])
        if not hasattr(prog, "live"):   # captured just now, by these stages
            prog.live = live
        return prog

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last training forward into ``grad_dict``, in
        place.  Without ``out_grads`` the head gradients are ones."""
        if self._train is None:
            if not self._grad_names:
                return  # nothing requires grad
            raise MXNetError("backward called before forward(is_train=True)")
        train, self._train = self._train, None
        if isinstance(train, capture.Program):
            if not train.live["diff"]:
                raise MXNetError("no output of the graph depends on an "
                                 "argument that requires a gradient")
            like = [o._data for o in self._outputs]
            train.replay(1, self._seeds(out_grads, like), clone=False)
            return
        outs, leaves = train
        self._differentiate(outs, leaves, self._seeds(out_grads, outs))

    def forward_backward(self, out_grads=None, **kwargs):
        """``forward(is_train=True)`` then ``backward(out_grads)``; on the
        card one captured program."""
        self._feed(kwargs)
        graph = self._graph()
        if graph is None or not self._grad_names:
            self._forward(True, graph)
            self.backward(out_grads)
            return self._outputs
        self._train = None

        def fwd_bwd(*seeds):
            outs, leaves = self._run(True, True)
            self._differentiate(outs, leaves, seeds or self._seeds(None, outs))
            return [o.detach() for o in outs]
        if out_grads is None:
            prog = self._program("forward_backward_ones", graph,
                                 lambda: [fwd_bwd])
            outs = prog.replay(0)
        else:
            seeds = self._seeds(out_grads, None)
            prog = self._program("forward_backward", graph,
                                 lambda: [fwd_bwd], seeds)
            outs = prog.replay(0, seeds)
        self._outputs = [NDArray(o, self._ctx) for o in outs]
        return self._outputs

    # -- params, reshape, monitor ------------------------------------------
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, array in (arg_params or {}).items():
            if name in self.arg_dict:
                array.copyto(self.arg_dict[name])
            elif not allow_extra_params:
                raise MXNetError("Found name \"%s\" that is not in the "
                                 "arguments" % name)
        for name, array in (aux_params or {}).items():
            if name in self.aux_dict:
                array.copyto(self.aux_dict[name])
            elif not allow_extra_params:
                raise MXNetError("Found name \"%s\" that is not in the "
                                 "auxiliary states" % name)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor bound at the input shapes ``kwargs``, the other
        arrays copied in where their shapes stay (reference
        ``mxnet_tpu/executor.py:487-504``)."""
        types = {n: a._data.dtype if not isinstance(
            a, _sparse.CSRNDArray) else _sparse.raw(a).dtype
            for n, a in self.arg_dict.items()}
        ex = Executor._simple_bind(self._symbol, self._ctx, self.grad_req,
                                   types, dict(kwargs), self._group2ctx)
        for n in ex.arg_names:
            if n not in kwargs and ex.arg_dict[n].shape \
                    == self.arg_dict[n].shape:
                self.arg_dict[n].copyto(ex.arg_dict[n])
        for n in ex.aux_names:
            if ex.aux_dict[n].shape == self.aux_dict[n].shape:
                self.aux_dict[n].copyto(ex.aux_dict[n])
        return ex

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, NDArray)`` on every op output of each
        forward (the graph then runs eagerly)."""
        self._monitor = callback

    def debug_str(self):
        lines = ["Symbol outputs: %s" % self.output_names]
        for n in self.arg_names:
            lines.append("arg %s: %s %s" % (n, self.arg_dict[n].shape,
                                            self.grad_req[n]))
        for n in self.aux_names:
            lines.append("aux %s: %s" % (n, self.aux_dict[n].shape))
        return "\n".join(lines)

    # -- binding entry points ---------------------------------------------
    @staticmethod
    def _bind(symbol, ctx, args, args_grad, grad_req, aux_states,
              group2ctx=None):
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        def as_dict(values, names):
            if isinstance(values, (list, tuple)):
                return dict(zip(names, values))
            return dict(values or {})
        return Executor(symbol, ctx, as_dict(args, arg_names),
                        as_dict(args_grad, arg_names), grad_req,
                        as_dict(aux_states, aux_names), group2ctx)

    @staticmethod
    def _simple_bind(symbol, ctx, grad_req, type_dict, shape_kwargs,
                     group2ctx=None):
        ctx = as_context(ctx)
        a, _, x = symbol._infer(shape_kwargs=shape_kwargs,
                                dtype_kwargs=type_dict)
        arg_names = symbol.list_arguments()
        unknown = [n for n, s in zip(arg_names, a) if s is None]
        if unknown:
            raise MXNetError("simple_bind could not infer shapes for %s; "
                             "pass their shapes as kwargs" % unknown)
        stypes = {n.name: n.attrs.get("__storage_type__")
                  for n in symbol._arg_nodes()}
        arg_dict = {n: arg_zeros(stypes[n], s, ctx)
                    for n, s in zip(arg_names, a)}
        aux_dict = {n: nd_zeros(tuple(s.shape), ctx=ctx, dtype=s.dtype)
                    for n, s in zip(symbol.list_auxiliary_states(), x)}
        return Executor(symbol, ctx, arg_dict, None, grad_req, aux_dict,
                        group2ctx)
