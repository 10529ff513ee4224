"""Symbol: the declarative graph IR.

Counterpart of ``mxnet_tpu/symbol/symbol.py:36-480``.  A Symbol is a small
Python DAG over the same op registry the eager path uses.  Shape and
dtype inference runs each op's own function on ``meta`` tensors (torch's
shape-only device), so inference cannot diverge from execution; binding
(``executor.py``) interprets the graph node by node.  ``tojson``/``save``
write MXNet's symbol JSON as the JAX package writes it (``:408-432``),
and ``load_json``/``load`` read it, upgrading the legacy dialects as the
JAX package does (``:514-600``).  The graph's introspection
(``get_internals``, ``get_children``, ``attr``/``list_attr``,
``debug_str``), its copies, the NDArray-style methods and ``eval``
follow ``:150-270`` and ``:433-476``; ``var`` reads the
:class:`~mxnet_tpu_torch.attribute.AttrScope` (``:485``).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..base import MXNetError, torch_dtype, np_dtype, dtype_name
from ..ops.registry import get_op, attr_to_string, parse_attr_string
from .. import name as _name_mod
from .. import attribute as _attr_mod
from .op_meta import infer_param_shapes, op_input_names, HINTS

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "zeros", "ones", "arange"]


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

    def attr(self, key):
        """The first output's node attribute ``key`` (its ``__key__`` form
        first) as a string, or None."""
        node = self._outputs[0][0]
        v = node.attrs.get("__" + key + "__", node.attrs.get(key))
        return attr_to_string(v) if v is not None else None

    def list_attr(self):
        """The first output's node attributes, keys without underscores."""
        node = self._outputs[0][0]
        return {k.strip("_"): attr_to_string(v)
                for k, v in node.attrs.items()}

    # -- selection ---------------------------------------------------------
    def get_internals(self):
        """Every output of every node (variables too), in topological
        order."""
        outs = []
        for node in _topo(self._outputs):
            outs.extend((node, i) for i in range(node.num_outputs()))
        return Symbol(outs)

    def get_children(self):
        """The inputs of the output nodes, or None for a variable."""
        kids = [inp for n, _ in self._outputs for inp in n.inputs]
        return Symbol(kids) if kids else None

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

    def __copy__(self):
        return Symbol(list(self._outputs))

    def __deepcopy__(self, memo):
        return load_json(self.tojson())

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

    def astype(self, dtype):
        return Symbol._from_op("Cast", [self], {"dtype": str(dtype)})

    def transpose(self, axes=None):
        return Symbol._from_op("transpose", [self], {"axes": axes})

    def flatten(self):
        return Symbol._from_op("Flatten", [self], {})

    def slice_axis(self, axis, begin, end):
        return Symbol._from_op("slice_axis", [self],
                               {"axis": axis, "begin": begin, "end": end})

    def softmax(self, axis=-1):
        return Symbol._from_op("softmax", [self], {"axis": axis})

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
                attrs = dict(node.attrs, ctx=torch.device("meta")) \
                    if node.op.no_inputs else node.attrs
                # a draw on meta tensors makes shapes only, so any
                # generator will do for an op that draws
                with torch.no_grad():
                    out = node.op.apply(
                        in_structs, attrs, rng=torch.Generator()
                        if node.op.needs_rng else None)
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

    # -- serialization -----------------------------------------------------
    def tojson(self):
        """The graph as MXNet's symbol JSON: nodes in topological order,
        their attrs as strings, ``arg_nodes``, ``heads`` and
        ``mxnet_version`` 1200 (``attrs.framework`` names this package)."""
        nodes = _topo(self._outputs)
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": "null" if n.op is None else n.op.name,
                "name": n.name,
                "attrs": {k: attr_to_string(v) for k, v in n.attrs.items()},
                "inputs": [[nid[id(s)], oi, 0] for s, oi in n.inputs],
            })
        graph = {
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.op is None],
            "heads": [[nid[id(n)], oi, 0] for n, oi in self._outputs],
            "attrs": {"mxnet_version": ["int", 1200],
                      "framework": ["str", "mxnet_tpu_torch"]},
        }
        return json.dumps(graph, indent=2)

    def save(self, fname):
        """Write :meth:`tojson` to ``fname`` (a path or a scheme URI,
        :mod:`mxnet_tpu_torch.stream`)."""
        from ..stream import open_stream
        with open_stream(fname, "w") as f:
            f.write(self.tojson())

    def debug_str(self):
        """The graph as text: the outputs, then each node in topological
        order, an op with its sorted attributes and its inputs by slot
        (``mxnet_tpu/symbol/symbol.py:433-455``)."""
        nodes = _topo(self._outputs)
        nid = {id(n): i for i, n in enumerate(nodes)}
        lines = ["Symbol Outputs:"]
        for pos, (n, oi) in enumerate(self._outputs):
            lines.append("\toutput[%d]=%s(%d)"
                         % (pos, n.output_name(oi), nid[id(n)]))
        for n in nodes:
            if n.op is None:
                lines.append("Variable:%s" % n.name)
                continue
            attrs = ", ".join("%s=%s" % (k, attr_to_string(v))
                              for k, v in sorted(n.attrs.items()))
            lines.append("--------------------")
            lines.append("Op:%s, Name=%s%s"
                         % (n.op.name, n.name,
                            (" {%s}" % attrs) if attrs else ""))
            for k, (src, oi) in enumerate(n.inputs):
                lines.append("\targ[%d]=%s(%d)"
                             % (k, src.output_name(oi), nid[id(src)]))
        return "\n".join(lines) + "\n"

    # -- binding (implemented in executor.py) ------------------------------
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None):
        from ..executor import Executor
        return Executor._bind(self, ctx, args, args_grad, grad_req,
                              aux_states, group2ctx)

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    group2ctx=None, **kwargs):
        from ..executor import Executor
        return Executor._simple_bind(self, ctx, grad_req, type_dict, kwargs,
                                     group2ctx)

    def eval(self, ctx=None, **kwargs):
        """The outputs (a list of NDArrays) of the graph bound on ``ctx``
        (default: the current context) with the arrays ``kwargs``."""
        from ..context import current_context
        return self.bind(ctx or current_context(), kwargs).forward()


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    """Create a variable symbol (reference ``mx.sym.var`` / ``Variable``).
    ``lr_mult``, ``wd_mult``, ``init`` and ``stype`` become the attrs
    ``__lr_mult__``, ``__wd_mult__``, ``__init__`` and
    ``__storage_type__`` that the optimizer, the initializer and the
    executor read.  The attributes of the enclosing
    :class:`~mxnet_tpu_torch.attribute.AttrScope` come first, ``attr``
    over them."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attrs = dict(_attr_mod.current().get(attr) or {})
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
    if stype is not None:
        attrs["__storage_type__"] = stype
    attrs.update({k: attr_to_string(v) for k, v in kwargs.items()})
    return Symbol([(SymNode(None, name, attrs, []), 0)])


Variable = var


def Group(symbols):
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


# -- creation symbols (``mxnet_tpu/symbol/symbol.py:597-611``) ---------------
def _dtype_attr(dtype):
    return "float32" if dtype is None else dtype_name(dtype)


def zeros(shape, dtype=None, **kwargs):
    return Symbol._from_op("_zeros", [], {"shape": shape,
                                          "dtype": _dtype_attr(dtype)})


def ones(shape, dtype=None, **kwargs):
    return Symbol._from_op("_ones", [], {"shape": shape,
                                         "dtype": _dtype_attr(dtype)})


def arange(start, stop=None, step=1.0, repeat=1, dtype=None, **kwargs):
    return Symbol._from_op("_arange", [], {
        "start": start, "stop": stop, "step": step, "repeat": repeat,
        "dtype": _dtype_attr(dtype)})


def load_json(json_str):
    """A Symbol from symbol JSON, of this package, of the JAX package or of
    MXNet (legacy dialects upgraded, :func:`_upgrade_json`).  A variable
    that feeds an op's auxiliary input is an auxiliary state."""
    graph = _upgrade_json(json.loads(json_str))
    nodes = [SymNode(None if jn["op"] == "null" else get_op(jn["op"]),
                     jn["name"],
                     {k: parse_attr_string(v)
                      for k, v in _node_attrs(jn).items()}, [])
             for jn in graph["nodes"]]
    for jn, node in zip(graph["nodes"], nodes):
        node.inputs = [(nodes[i], oi) for i, oi, *_ in jn["inputs"]]
        if node.op is not None:
            _, aux_names = op_input_names(node.op, node.attrs)
            first_aux = len(node.inputs) - len(aux_names)
            for pos, (src, _) in enumerate(node.inputs):
                if pos >= first_aux and src.op is None:
                    src.is_aux = True
    return Symbol([(nodes[i], oi) for i, oi, *_ in graph["heads"]])


def _node_attrs(jn):
    """Node attr dict across JSON generations: modern ``attrs``, 0.9-era
    ``attr``, pre-0.9 ``param`` (reference legacy_json_util.cc upgrades the
    same progression in place)."""
    return jn.get("attrs") or jn.get("attr") or jn.get("param") or {}


def _upgrade_json(graph):
    """Upgrade legacy symbol JSON in place, as the JAX package does
    (``mxnet_tpu/symbol/symbol.py:547-583``, after the reference's
    src/nnvm/legacy_json_util.cc): (a) node attrs under ``attr`` or
    ``param`` move to ``attrs``; (b) a variable's flat metadata
    (``init``, ``lr_mult``, ``wd_mult``, ``dtype``, ``shape``) takes its
    ``__key__`` form; (c) before 0.9, variable metadata left on the
    consuming op node (``init``, ``lr_mult``, ``wd_mult``) takes it too,
    while an op's own ``dtype``/``shape`` stay."""
    version = 0
    g_attrs = graph.get("attrs") or {}
    if isinstance(g_attrs.get("mxnet_version"), (list, tuple)) \
            and len(g_attrs["mxnet_version"]) == 2:
        version = int(g_attrs["mxnet_version"][1])
    for jn in graph.get("nodes", []):
        attrs = _node_attrs(jn)
        if jn.get("op") == "null":
            for key in ("init", "lr_mult", "wd_mult", "dtype", "shape"):
                if key in attrs:
                    attrs["__%s__" % key] = attrs.pop(key)
        elif version < 900:
            for key in ("init", "lr_mult", "wd_mult"):
                if key in attrs:
                    attrs["__%s__" % key] = attrs.pop(key)
        jn.pop("param", None)
        jn.pop("attr", None)
        jn["attrs"] = attrs
    return graph


def load(fname):
    """A Symbol from a JSON file (a path or a scheme URI)."""
    from ..stream import open_stream
    with open_stream(fname, "r") as f:
        return load_json(f.read())
