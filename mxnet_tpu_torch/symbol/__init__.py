"""``sym`` namespace: Symbol and the generated symbolic op functions.

Counterpart of ``mxnet_tpu/symbol/__init__.py:20-105``.  Symbolic op
functions take Symbols positionally or by input name
(``sym.FullyConnected(data=d, ...)``) and create variable nodes for the
parameter inputs left out (``fc1_weight``, ``fc1_bias``), which
``simple_bind`` then sizes from the data shape.
"""
from __future__ import annotations

import sys
import types

from .symbol import Symbol, SymNode, var, Variable, Group
from .op_meta import op_input_names, HINTS
from ..ops.registry import OP_REGISTRY
from .. import name as _name_mod


def _make_sym_func(name, op):
    def sym_func(*args, **kwargs):
        attr = kwargs.pop("attr", None)
        sym_name = kwargs.pop("name", None)
        sym_kwargs = {k: kwargs.pop(k) for k in list(kwargs)
                      if isinstance(kwargs[k], Symbol)}
        pos_syms = []
        for a in args:
            if isinstance(a, Symbol):
                pos_syms.append(a)
            elif isinstance(a, (list, tuple)) and a and isinstance(a[0],
                                                                   Symbol):
                pos_syms.extend(a)
            else:
                raise TypeError("op %s: non-Symbol positional args not "
                                "allowed; pass attrs as keywords" % name)
        in_names, aux_names = op_input_names(op, kwargs)
        all_names = in_names + aux_names
        hint = HINTS.get(name, name.lower().strip("_"))
        node_name = _name_mod.current().get(sym_name, hint)
        # inputs: by name, then positional in order, then new variables
        inputs = []
        pos_iter = iter(pos_syms)
        for iname in all_names:
            if iname in sym_kwargs:
                inputs.append(sym_kwargs.pop(iname))
                continue
            s = next(pos_iter, None)
            if s is None:
                s = var("%s_%s" % (node_name, iname))
            inputs.append(s)
        inputs.extend(pos_iter)
        if sym_kwargs:
            raise TypeError("op %s got unexpected symbol kwargs %s (inputs "
                            "are %s)" % (name, list(sym_kwargs), all_names))
        if attr:
            kwargs.update({"__%s__" % k: v for k, v in attr.items()})
        for iname, s in zip(all_names, inputs):
            if iname in aux_names and s._outputs[0][0].op is None:
                s._outputs[0][0].is_aux = True
        return Symbol._from_op(name, inputs, kwargs, name=node_name)
    sym_func.__name__ = name
    return sym_func


_internal = types.ModuleType(__name__ + "._internal")
_this = sys.modules[__name__]
for _name, _op in OP_REGISTRY.items():
    _fn = _make_sym_func(_name, _op)
    setattr(_internal, _name, _fn)
    if not _name.startswith("_") and not hasattr(_this, _name):
        setattr(_this, _name, _fn)
sys.modules[__name__ + "._internal"] = _internal

__all__ = ["Symbol", "SymNode", "var", "Variable", "Group"]
