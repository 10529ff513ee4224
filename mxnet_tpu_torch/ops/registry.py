"""Operator registry: one PyTorch function per op, shared by every frontend.

Counterpart of ``mxnet_tpu/ops/registry.py:64-215``.  An op is a function
``fn(*tensors, **attrs)`` returning one tensor or a tuple.  Gradients come
from torch's autograd over the same function, except where MXNet defines
a *semantic* gradient that differs from the mathematical one
(SoftmaxOutput, user kernels registered with ``grad=``): those declare
``custom_vjp`` and run inside a ``torch.autograd.Function``.

Attributes serialize to strings for symbol parity; ``parse_attr_string``
and ``attr_to_string`` are this package's own copies.
"""
from __future__ import annotations

import ast

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["Op", "register", "get_op", "list_ops", "OP_REGISTRY",
           "parse_attr_string", "attr_to_string"]

OP_REGISTRY = {}


def parse_attr_string(v):
    """Parse a stringified attr back to a python value (symbol JSON parity)."""
    if not isinstance(v, str):
        return v
    s = v.strip()
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return v


def attr_to_string(v):
    if isinstance(v, str):
        return v
    if isinstance(v, (bool, int, float, type(None))):
        return str(v)
    if isinstance(v, (tuple, list)):
        if len(v) == 1:  # "(64,)" — "(64)" would parse back as an int
            return "(%s,)" % v[0]
        return "(" + ", ".join(str(x) for x in v) + ")"
    if isinstance(v, np.dtype):
        return v.name
    return str(v)


class _SemanticGrad(torch.autograd.Function):
    """Runs an op forward outside autograd and differentiates it with its
    ``custom_vjp`` (the counterpart of ``jax.custom_vjp`` in
    ``mxnet_tpu/ops/registry.py:129-156``)."""

    @staticmethod
    def forward(ctx, op, attrs, train_mode, rng, *inputs):
        outs = op.apply(inputs, attrs, train_mode=train_mode, rng=rng)
        ctx.op, ctx.attrs, ctx.n_in = op, attrs, len(inputs)
        # saved, not kept as attributes: an output held by its own grad_fn
        # would be a reference cycle
        ctx.save_for_backward(*inputs, *outs)
        return outs

    @staticmethod
    def backward(ctx, *out_grads):
        saved = ctx.saved_tensors
        grads = ctx.op.custom_vjp(out_grads, saved[:ctx.n_in],
                                  saved[ctx.n_in:], ctx.attrs)
        return (None, None, None, None) + tuple(grads)


class Op:
    """A registered operator.

    Parameters
    ----------
    name : canonical op name (MXNet-compatible, e.g. ``FullyConnected``).
    fn : function ``(*tensors, **attrs) -> tensor | tuple``.  If
        ``takes_mode``, it receives ``train_mode=<bool>``; if ``needs_rng``
        it receives ``rng=<torch.Generator>``.
    num_outputs : int or callable(attrs) -> int.
    num_visible_outputs : outputs exposed to the user (BatchNorm registers
        3 outputs, 1 visible).
    nondiff_inputs : input positions excluded from autograd (labels, aux
        state).
    aux_updates : {aux_input_pos: output_pos} — outputs that are *new values
        of auxiliary state* (optimizer state slots, BatchNorm moving
        stats).  Eager mode writes them back into the aux NDArray in place;
        the executor updates its aux dict; they are never differentiated.
    custom_vjp : optional ``bwd(out_grads, inputs, outputs, attrs) ->
        input_grads`` (one per input), used instead of autograd (semantic
        gradients).
    """

    def __init__(self, name, fn, num_outputs=1, num_visible_outputs=None,
                 nondiff_inputs=(), aux_updates=None, takes_mode=False,
                 needs_rng=False, custom_vjp=None, attr_defaults=None):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.num_visible_outputs = num_visible_outputs
        self.nondiff_inputs = tuple(nondiff_inputs)
        self.aux_updates = dict(aux_updates or {})
        self.takes_mode = takes_mode
        self.needs_rng = needs_rng
        self.custom_vjp = custom_vjp
        self.attr_defaults = dict(attr_defaults or {})

    def n_outputs(self, attrs):
        if callable(self.num_outputs):
            return self.num_outputs(attrs)
        return self.num_outputs

    def n_visible_outputs(self, attrs):
        if self.num_visible_outputs is None:
            return self.n_outputs(attrs) - len(self.aux_updates)
        if callable(self.num_visible_outputs):
            return self.num_visible_outputs(attrs)
        return self.num_visible_outputs

    def apply(self, inputs, attrs, train_mode=False, rng=None):
        """Run the function; always returns a tuple of tensors."""
        kw = dict(attrs)
        if self.takes_mode:
            kw["train_mode"] = train_mode
        if self.needs_rng:
            kw["rng"] = rng
        out = self.fn(*inputs, **kw)
        if isinstance(out, (tuple, list)):
            return tuple(out)
        return (out,)

    def traceable(self, attrs, train_mode=False, rng=None):
        """A callable ``f(*tensors) -> tuple`` with attrs closed over that
        autograd differentiates, through ``custom_vjp`` where it is set."""
        if self.custom_vjp is None:
            def plain(*tensors):
                return self.apply(tensors, attrs, train_mode=train_mode,
                                  rng=rng)
            return plain

        def semantic(*tensors):
            return _SemanticGrad.apply(self, attrs, train_mode, rng, *tensors)
        return semantic

    def __repr__(self):
        return "Op(%s)" % self.name


def register(name, aliases=(), **kwargs):
    """Decorator: register a function as operator ``name``."""
    def deco(fn):
        op = Op(name, fn, **kwargs)
        OP_REGISTRY[name] = op
        for a in aliases:
            OP_REGISTRY[a] = op
        return fn
    return deco


def get_op(name):
    if name not in OP_REGISTRY:
        raise MXNetError("Operator %s is not registered (have %d ops)"
                         % (name, len(OP_REGISTRY)))
    return OP_REGISTRY[name]


def list_ops():
    return sorted(OP_REGISTRY)
