"""Network visualization: ``print_summary`` and ``plot_network``.

Counterpart of ``mxnet_tpu/visualization.py:1-156``, reading the Symbol's
node graph the same way, so both packages print the same table for the
same graph: each op node's name and op, its output shape (from
``shape``, by symbolic shape inference), its parameter count (the
elements of its inputs that are variables other than data) and the op
nodes before it.  ``plot_network`` builds a ``graphviz.Digraph`` where
``graphviz`` imports, and raises ``ImportError`` where it does not, as
the JAX package does.
"""
from __future__ import annotations

from .symbol.symbol import Symbol, _topo

__all__ = ["print_summary", "plot_network"]


def _node_label(node):
    return node.op.name if node.op is not None else "null"


def print_summary(symbol, shape=None, line_length=120, positions=None):
    """Print a table of the layers, one op node a row, and return the
    total parameter count; ``shape`` ({input name: shape}) gives the
    output shapes and the parameters' sizes."""
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be a Symbol")
    positions = positions or [0.44, 0.64, 0.74, 1.0]
    shape_dict = {}
    if shape is not None:
        internals = symbol.get_internals()
        _, out_shapes, _ = internals.infer_shape(**shape)
        shape_dict = dict(zip(internals.list_outputs(), out_shapes))

    nodes = _topo(symbol._outputs)
    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(f, pos):
        line = ""
        for i, field in enumerate(f):
            line += str(field)
            line = line[:pos[i]]
            line += " " * (pos[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(fields, positions)
    print("=" * line_length)
    total_params = 0
    arg_names = set(symbol.list_arguments())
    data_names = {n for n in arg_names
                  if not n.endswith(("weight", "bias", "gamma", "beta"))}
    arg_shapes = _arg_shapes(symbol, shape)
    for node in nodes:
        if node.op is None:
            continue
        out_shape = shape_dict.get(node.output_name(0))
        params = 0
        pre = []
        for src, _ in node.inputs:
            if src.op is None:
                if src.name not in data_names:
                    pshape = shape_dict.get(src.name + "_output") or \
                        arg_shapes.get(src.name)
                    if pshape:
                        n_el = 1
                        for s in pshape:
                            n_el *= s
                        params += n_el
            else:
                pre.append(src.name)
        total_params += params
        print_row(["%s(%s)" % (node.name, _node_label(node)),
                   str(out_shape) if out_shape else "",
                   str(params), ",".join(pre)], positions)
        print("_" * line_length)
    print("Total params: {}".format(total_params))
    print("_" * line_length)
    return total_params


def _arg_shapes(symbol, shape):
    """{argument: shape or None} by partial inference from ``shape``, once
    for the whole table; empty where it fails or no shape is given."""
    if shape is None:
        return {}
    try:
        shapes, _, _ = symbol.infer_shape_partial(**shape)
    except Exception:
        return {}
    return dict(zip(symbol.list_arguments(), shapes))


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """A ``graphviz.Digraph`` of the network: variables as ovals (the
    weights, biases and statistics hidden by default), ops as boxes
    (``Convolution``/``FullyConnected`` with their width), edges
    labelled with the shape without the batch axis where ``shape`` is
    given.  Raises ``ImportError`` without ``graphviz``."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("Draw network requires graphviz library")
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be a Symbol")
    node_attrs = node_attrs or {}

    shape_dict = {}
    if shape is not None:
        internals = symbol.get_internals()
        _, out_shapes, _ = internals.infer_shape(**shape)
        shape_dict = dict(zip(internals.list_outputs(), out_shapes))

    node_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    node_attr.update(node_attrs)
    dot = Digraph(name=title, format=save_format)

    nodes = _topo(symbol._outputs)
    hidden = set()
    for node in nodes:
        name = node.name
        if node.op is None:
            if hide_weights and name.endswith(
                    ("weight", "bias", "gamma", "beta", "running_mean",
                     "running_var", "moving_mean", "moving_var")):
                hidden.add(id(node))
                continue
            dot.node(name=name, label=name, shape="oval",
                     fillcolor="#8dd3c7", style="filled")
        else:
            label = node.op.name
            if node.op.name in ("Convolution", "FullyConnected"):
                label = "%s\n%s" % (node.op.name,
                                    node.attrs.get("num_filter",
                                                   node.attrs.get(
                                                       "num_hidden", "")))
            dot.node(name=name, label=label, fillcolor="#fb8072",
                     **node_attr)
    for node in nodes:
        if node.op is None:
            continue
        for src, oi in node.inputs:
            if id(src) in hidden:
                continue
            label = ""
            out_name = src.output_name(oi) if src.op is not None else None
            if out_name and out_name in shape_dict:
                label = "x".join(str(s) for s in shape_dict[out_name][1:])
            dot.edge(tail_name=src.name, head_name=node.name, label=label)
    return dot
