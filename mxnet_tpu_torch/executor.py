"""Executor: a bound symbolic graph, interpreted node by node over torch
tensors.

Counterpart of ``mxnet_tpu/executor.py:55-470``.  The JAX package traces
the graph into jitted programs and differentiates it with ``jax.vjp``;
here ``forward`` walks the graph in topological order, calling each op on
the bound tensors, and a training forward runs under torch's grad mode so
that ``backward`` asks torch's autograd for the gradients.  Gradients are
written into the existing ``grad_dict`` NDArrays in place (``add``
accumulates), so an optimizer that holds them sees every step's values;
aux states (moving statistics) are written back the same way.  There is
no jit, graph capture or ``group2ctx`` path.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import as_context
from . import random as _random
from .ndarray import NDArray, zeros as nd_zeros
from .symbol.symbol import _topo

__all__ = ["Executor"]


def _run_graph(symbol, arg_vals, aux_vals, train_mode, gen):
    """Run the graph on tensors: {arg name: tensor}, {aux name: tensor}
    -> (outputs, {aux name: new value})."""
    env = {}
    new_aux = {}
    for node in _topo(symbol._outputs):
        if node.op is None:
            env[(id(node), 0)] = (aux_vals if node.is_aux
                                  else arg_vals)[node.name]
            continue
        ins = [env[(id(s), oi)] for s, oi in node.inputs]
        outs = node.op.traceable(node.attrs, train_mode=train_mode,
                                 rng=gen if node.op.needs_rng else None)(*ins)
        for i, o in enumerate(outs):
            env[(id(node), i)] = o
        for aux_in, out_idx in node.op.aux_updates.items():
            src = node.inputs[aux_in][0] if aux_in < len(node.inputs) else None
            if src is not None and src.op is None and src.is_aux:
                new_aux[src.name] = outs[out_idx]
    return [env[(id(n), oi)] for n, oi in symbol._outputs], new_aux


class Executor:
    """A bound computation graph (create with ``Symbol.bind`` or
    ``Symbol.simple_bind``)."""

    def __init__(self, symbol, ctx, arg_dict, grad_dict, grad_req, aux_dict):
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
        self._train = None  # (output tensors, leaf tensors) until backward
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
    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` are copied into ``arg_dict`` first.
        A training forward keeps what ``backward`` needs."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown argument %s" % k)
            self.arg_dict[k]._set_data(
                v._data if isinstance(v, NDArray)
                else torch.from_numpy(np.array(v)))
        arg_vals = {n: a._data for n, a in self.arg_dict.items()}
        aux_vals = {n: a._data for n, a in self.aux_dict.items()}
        gen = _random.generator(self._ctx)
        self._train = None
        if is_train and self._grad_names:
            leaves = {n: arg_vals[n].detach().requires_grad_(True)
                      for n in self._grad_names}
            arg_vals.update(leaves)
            with torch.enable_grad():
                outs, new_aux = _run_graph(self._symbol, arg_vals, aux_vals,
                                           True, gen)
            self._train = (outs, [leaves[n] for n in self._grad_names])
        else:
            with torch.no_grad():
                outs, new_aux = _run_graph(self._symbol, arg_vals, aux_vals,
                                           is_train, gen)
        for n, v in new_aux.items():
            self.aux_dict[n]._set_data(v)
        self._outputs = [NDArray(o.detach(), self._ctx) for o in outs]
        return self._outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last training forward into ``grad_dict``, in
        place.  Without ``out_grads`` the head gradients are ones."""
        if self._train is None:
            if not self._grad_names:
                return  # nothing requires grad
            raise MXNetError("backward called before forward(is_train=True)")
        outs, leaves = self._train
        if out_grads is None:
            seeds = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            seeds = [g._data if isinstance(g, NDArray)
                     else torch.as_tensor(g, device=o.device)
                     for g, o in zip(out_grads, outs)]
        diff = [(o, s) for o, s in zip(outs, seeds) if o.requires_grad]
        if not diff:
            raise MXNetError("no output of the graph depends on an argument "
                             "that requires a gradient")
        grads = torch.autograd.grad([o for o, _ in diff], leaves,
                                    [s for _, s in diff], allow_unused=True)
        self._train = None
        with torch.no_grad():
            for n, g in zip(self._grad_names, grads):
                dst = self.grad_dict[n]._data
                if g is None:  # the argument does not reach an output
                    if self.grad_req[n] == "write":
                        dst.zero_()
                elif self.grad_req[n] == "add":
                    dst.add_(g)
                else:
                    dst.copy_(g)

    def forward_backward(self, out_grads=None, **kwargs):
        """``forward(is_train=True)`` then ``backward(out_grads)``."""
        self.forward(is_train=True, **kwargs)
        self.backward(out_grads)
        return self._outputs

    # -- params ------------------------------------------------------------
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

    # -- binding entry points ---------------------------------------------
    @staticmethod
    def _bind(symbol, ctx, args, args_grad, grad_req, aux_states):
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        def as_dict(values, names):
            if isinstance(values, (list, tuple)):
                return dict(zip(names, values))
            return dict(values or {})
        return Executor(symbol, ctx, as_dict(args, arg_names),
                        as_dict(args_grad, arg_names), grad_req,
                        as_dict(aux_states, aux_names))

    @staticmethod
    def _simple_bind(symbol, ctx, grad_req, type_dict, shape_kwargs):
        ctx = as_context(ctx)
        a, _, x = symbol._infer(shape_kwargs=shape_kwargs,
                                dtype_kwargs=type_dict)
        arg_names = symbol.list_arguments()
        unknown = [n for n, s in zip(arg_names, a) if s is None]
        if unknown:
            raise MXNetError("simple_bind could not infer shapes for %s; "
                             "pass their shapes as kwargs" % unknown)
        arg_dict = {n: nd_zeros(tuple(s.shape), ctx=ctx, dtype=s.dtype)
                    for n, s in zip(arg_names, a)}
        aux_dict = {n: nd_zeros(tuple(s.shape), ctx=ctx, dtype=s.dtype)
                    for n, s in zip(symbol.list_auxiliary_states(), x)}
        return Executor(symbol, ctx, arg_dict, None, grad_req, aux_dict)
