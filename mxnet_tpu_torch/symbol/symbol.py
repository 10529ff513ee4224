"""Symbol: the declarative graph IR.

Counterpart of ``mxnet_tpu/symbol/symbol.py:36-480``.  A Symbol is a small
Python DAG over the same op registry the eager path uses.  Shape and
dtype inference runs each op's own function on ``meta`` tensors (torch's
shape-only device), so inference cannot diverge from execution; binding
(``executor.py``) interprets the graph node by node.  JSON save/load is
not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, torch_dtype, np_dtype, dtype_name
from ..ops.registry import get_op, attr_to_string
from .. import name as _name_mod
from .op_meta import infer_param_shapes, HINTS

__all__ = ["Symbol", "var", "Variable", "Group"]


class SymNode:
    """One graph node: an op application or a variable (op=None)."""
    __slots__ = ("op", "name", "attrs", "inputs", "is_aux")

    def __init__(self, op, name, attrs, inputs, is_aux=False):
        self.op = op            # Op or None for variables
        self.name = name
        self.attrs = attrs      # python-typed attrs
        self.inputs = inputs    # list[(SymNode, out_idx)]
        self.is_aux = is_aux

    def num_outputs(self):
        return 1 if self.op is None else self.op.n_visible_outputs(self.attrs)

    def output_name(self, idx):
        if self.op is None:
            return self.name
        if self.num_outputs() == 1:
            return self.name + "_output"
        return "%s_output%d" % (self.name, idx)


def _topo(heads):
    """Post-order DFS over the graph of the given head nodes."""
    order, seen = [], set()

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for inp, _ in node.inputs:
            visit(inp)
        order.append(node)

    for node, _ in heads:
        visit(node)
    return order


class Symbol:
    """Immutable handle over one or more graph outputs."""
    __slots__ = ("_outputs",)

    def __init__(self, outputs):
        self._outputs = list(outputs)  # list[(SymNode, out_idx)]

    # -- construction ------------------------------------------------------
    @staticmethod
    def _from_op(op_name, input_syms, attrs, name=None):
        op = get_op(op_name)
        hint = HINTS.get(op_name, op_name.lower().replace("_", ""))
        name = _name_mod.current().get(name, hint)
        inputs = []
        for s in input_syms:
            if len(s._outputs) != 1:
                raise MXNetError(
                    "cannot compose op %s with a multi-output symbol; "
                    "select one output first" % op_name)
            inputs.append(s._outputs[0])
        node = SymNode(op, name, {k: v for k, v in attrs.items()
                                  if v is not None}, inputs)
        return Symbol([(node, i) for i in range(node.num_outputs())])

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    # -- listing -----------------------------------------------------------
    def _arg_nodes(self):
        return [n for n in _topo(self._outputs)
                if n.op is None and not n.is_aux]

    def _aux_nodes(self):
        return [n for n in _topo(self._outputs) if n.op is None and n.is_aux]

    def list_arguments(self):
        return [n.name for n in self._arg_nodes()]

    def list_auxiliary_states(self):
        return [n.name for n in self._aux_nodes()]

    def list_outputs(self):
        return [n.output_name(i) for n, i in self._outputs]

    def list_inputs(self):
        return self.list_arguments() + self.list_auxiliary_states()

    @property
    def num_outputs(self):
        return len(self._outputs)

    def __len__(self):
        return len(self._outputs)

    def attr_dict(self):
        """{node name: {attr: string}}, special attrs in their dunder form
        (``__init__``, ``__lr_mult__``), as the initializer and the
        optimizer look them up (``mxnet_tpu/symbol/symbol.py:177``)."""
        return {node.name: {k: attr_to_string(v)
                            for k, v in node.attrs.items()}
                for node in _topo(self._outputs) if node.attrs}

    # -- selection ---------------------------------------------------------
    def __getitem__(self, index):
        if isinstance(index, str):
            matches = [i for i, (n, oi) in enumerate(self._outputs)
                       if n.output_name(oi) == index or n.name == index]
            if not matches:
                raise ValueError("no output named %r in %s"
                                 % (index, self.list_outputs()))
            index = matches[0]
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    # -- arithmetic --------------------------------------------------------
    def _binary(self, op_name, scalar_op, other, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return Symbol._from_op(op_name, [a, b], {})
        if isinstance(other, (int, float, np.generic)):
            return Symbol._from_op(scalar_op, [self], {"scalar": float(other)})
        raise TypeError("unsupported operand %r" % (type(other),))

    def __add__(self, o): return self._binary("elemwise_add", "_plus_scalar", o)
    def __radd__(self, o): return self._binary("elemwise_add", "_plus_scalar", o, True)
    def __sub__(self, o): return self._binary("elemwise_sub", "_minus_scalar", o)

    def __rsub__(self, o):
        if isinstance(o, Symbol):
            return o.__sub__(self)
        return Symbol._from_op("_rminus_scalar", [self], {"scalar": float(o)})

    def __mul__(self, o): return self._binary("elemwise_mul", "_mul_scalar", o)
    def __rmul__(self, o): return self._binary("elemwise_mul", "_mul_scalar", o, True)
    def __truediv__(self, o): return self._binary("elemwise_div", "_div_scalar", o)

    def __rtruediv__(self, o):
        if isinstance(o, Symbol):
            return o.__truediv__(self)
        return Symbol._from_op("_rdiv_scalar", [self], {"scalar": float(o)})

    def __pow__(self, o): return self._binary("elemwise_power", "_power_scalar", o)
    def __neg__(self): return Symbol._from_op("negative", [self], {})

    def __eq__(self, o):
        if isinstance(o, (Symbol, int, float, np.generic)):
            return self._binary("_equal", "_equal_scalar", o)
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (Symbol, int, float, np.generic)):
            return self._binary("_not_equal", "_not_equal_scalar", o)
        return NotImplemented

    def __gt__(self, o): return self._binary("_greater", "_greater_scalar", o)
    def __ge__(self, o): return self._binary("_greater_equal", "_greater_equal_scalar", o)
    def __lt__(self, o): return self._binary("_lesser", "_lesser_scalar", o)
    def __le__(self, o): return self._binary("_lesser_equal", "_lesser_equal_scalar", o)
    __hash__ = object.__hash__

    # -- convenience methods mirroring NDArray ----------------------------
    def reshape(self, *shape, **kw):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kw.get("shape", shape)
        return Symbol._from_op("Reshape", [self], {"shape": tuple(shape)})

    def sum(self, axis=None, keepdims=False):
        return Symbol._from_op("sum", [self],
                               {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return Symbol._from_op("mean", [self],
                               {"axis": axis, "keepdims": keepdims})

    def flatten(self):
        return Symbol._from_op("Flatten", [self], {})

    def __repr__(self):
        outs = self.list_outputs()
        return "<Symbol %s>" % (self.name if len(outs) == 1 else outs)

    # -- inference ---------------------------------------------------------
    def _infer(self, shape_kwargs=None, dtype_kwargs=None, partial=False):
        """Joint shape and dtype inference: each op runs on ``meta``
        tensors.  Returns (args, outputs, auxs), each a list of ``meta``
        tensors or None (unknown)."""
        shape_kwargs = dict(shape_kwargs or {})
        dtype_kwargs = dict(dtype_kwargs or {})
        nodes = _topo(self._outputs)
        vals = {}  # id(node) -> list of meta tensors or None
        var_struct = {}

        def struct_of(node):
            shape = shape_kwargs.get(node.name)
            if shape is None:
                shape = node.attrs.get("__shape__")
            if shape is None:
                return None
            if isinstance(shape, (int, np.integer)):
                shape = (int(shape),)
            dtype = dtype_kwargs.get(node.name,
                                     node.attrs.get("__dtype__", "float32"))
            return torch.empty(tuple(shape), dtype=torch_dtype(dtype),
                               device="meta")

        for node in nodes:
            if node.op is None:
                vals[id(node)] = [struct_of(node)]
                var_struct[id(node)] = vals[id(node)][0]

        for node in nodes:
            if node.op is None:
                continue
            in_structs = [vals[id(n)][oi] for n, oi in node.inputs]
            if any(s is None for s in in_structs):
                inferred = infer_param_shapes(node, in_structs)
                for pos, st in enumerate(inferred or ()):
                    if st is not None and in_structs[pos] is None:
                        in_structs[pos] = st
                        src, soi = node.inputs[pos]
                        if src.op is None:
                            vals[id(src)][soi] = st
                            var_struct[id(src)] = st
            if any(s is None for s in in_structs):
                if partial:
                    vals[id(node)] = [None] * node.num_outputs()
                    continue
                missing = [node.inputs[i][0].name
                           for i, s in enumerate(in_structs) if s is None]
                raise MXNetError(
                    "cannot infer shape for inputs %s of node %s; provide "
                    "their shapes" % (missing, node.name))
            try:
                with torch.no_grad():
                    out = node.op.apply(in_structs, node.attrs)
            except Exception as e:  # any op error is an inference failure
                raise MXNetError("shape inference failed at node %s (op %s): "
                                 "%s" % (node.name, node.op.name, e)) from e
            vals[id(node)] = list(out)

        args = [var_struct.get(id(n)) for n in self._arg_nodes()]
        auxs = [var_struct.get(id(n)) for n in self._aux_nodes()]
        outs = [vals[id(n)][oi] for n, oi in self._outputs]
        return args, outs, auxs

    def infer_shape(self, *args, **kwargs):
        if args:
            kwargs = dict(zip(self.list_arguments(), args), **kwargs)
        kwargs = {k: v for k, v in kwargs.items() if v is not None}
        a, o, x = self._infer(shape_kwargs=kwargs)
        if any(s is None for s in a + o + x):
            return None, None, None
        return ([tuple(s.shape) for s in a], [tuple(s.shape) for s in o],
                [tuple(s.shape) for s in x])

    def infer_shape_partial(self, *args, **kwargs):
        if args:
            kwargs = dict(zip(self.list_arguments(), args), **kwargs)
        kwargs = {k: v for k, v in kwargs.items() if v is not None}
        a, o, x = self._infer(shape_kwargs=kwargs, partial=True)

        def shape(s):
            return tuple(s.shape) if s is not None else None
        return [shape(s) for s in a], [shape(s) for s in o], \
            [shape(s) for s in x]

    def infer_type(self, *args, **kwargs):
        """Shape-free dtype propagation: known dtypes flow forward through
        the ops, and unknown variable dtypes are back-filled from their
        consumers (so weights inherit the data dtype).  Types are numpy
        dtypes, and ``torch.bfloat16``, which numpy lacks."""
        if args:
            kwargs = dict(zip(self.list_arguments(), args), **kwargs)
        nodes = _topo(self._outputs)
        dt = {}  # id(node) -> torch.dtype or None
        for n in nodes:
            if n.op is None:
                d = kwargs.get(n.name, n.attrs.get("__dtype__"))
                dt[id(n)] = torch_dtype(d) if d is not None else None
        for _ in range(2):  # forward, back-fill, forward again
            for n in nodes:
                if n.op is None:
                    continue
                if n.attrs.get("dtype") is not None:
                    dt[id(n)] = torch_dtype(n.attrs["dtype"])
                    continue
                known = [dt.get(id(s)) for s, _ in n.inputs]
                known = [k for k in known if k is not None]
                dt[id(n)] = known[0] if known else dt.get(id(n))
            for n in nodes:
                if n.op is None or dt.get(id(n)) is None:
                    continue
                for s, _ in n.inputs:
                    if s.op is None and dt.get(id(s)) is None:
                        dt[id(s)] = dt[id(n)]

        def f(node):
            return np_dtype(dt.get(id(node)) or torch.float32)
        return ([f(n) for n in self._arg_nodes()],
                [f(n) for n, _ in self._outputs],
                [f(n) for n in self._aux_nodes()])

    # -- binding (implemented in executor.py) ------------------------------
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None):
        from ..executor import Executor
        return Executor._bind(self, ctx, args, args_grad, grad_req,
                              aux_states)

    def simple_bind(self, ctx, grad_req="write", type_dict=None, **kwargs):
        from ..executor import Executor
        return Executor._simple_bind(self, ctx, grad_req, type_dict, kwargs)


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, **kwargs):
    """Create a variable symbol (reference ``mx.sym.var`` / ``Variable``).
    ``lr_mult``, ``wd_mult`` and ``init`` become the attrs ``__lr_mult__``,
    ``__wd_mult__`` and ``__init__`` that the optimizer and the
    initializer read."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attrs = dict(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype)
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    if init is not None:
        attrs["__init__"] = init.dumps() if hasattr(init, "dumps") \
            else str(init)
    attrs.update({k: attr_to_string(v) for k, v in kwargs.items()})
    return Symbol([(SymNode(None, name, attrs, []), 0)])


Variable = var


def Group(symbols):
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)
