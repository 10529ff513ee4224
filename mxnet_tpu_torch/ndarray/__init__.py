"""``nd`` namespace: NDArray and the generated operator functions.

Counterpart of ``mxnet_tpu/ndarray/__init__.py:21-86``: one function per
registered op, made from the registry at import.  Public
(non-underscore) ops land in this namespace; every op lands in
``mxnet_tpu_torch.ndarray._internal``.  Kernels registered later by
``rtc.register`` are added the same way.
"""
from __future__ import annotations

import inspect
import sys
import types

from .ndarray import (NDArray, array, zeros, ones, full, empty, invoke,
                      concatenate, params_from_jax)
from ..ops.registry import OP_REGISTRY


def _scalar_attr_names(op):
    """Keyword parameter names of the op fn, in declaration order (for
    mapping scalar positional args)."""
    try:
        sig = inspect.signature(op.fn)
    except (TypeError, ValueError):
        return []
    return [p.name for p in sig.parameters.values()
            if p.default is not inspect.Parameter.empty
            and p.name not in ("train_mode", "rng")]


def _make_op_func(name, op):
    def op_func(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        ndargs, scalars = [], []
        for a in args:
            if isinstance(a, NDArray):
                ndargs.append(a)
            elif isinstance(a, (list, tuple)) and a and isinstance(a[0],
                                                                   NDArray):
                ndargs.extend(a)
            elif a is not None:
                scalars.append(a)
        if scalars:
            # scalar positionals fill the op's attr params in order
            free = [n for n in _scalar_attr_names(op) if n not in kwargs]
            if len(scalars) > len(free):
                raise TypeError(
                    "operator %s got %d scalar positional args but only "
                    "has attr slots %s" % (name, len(scalars), free))
            kwargs.update(zip(free, scalars))
        res = invoke(op, ndargs, kwargs, out=out)
        return res[0] if len(res) == 1 else res
    op_func.__name__ = name
    op_func.__doc__ = op.fn.__doc__
    return op_func


_internal = types.ModuleType(__name__ + "._internal")
_this = sys.modules[__name__]
for _name, _op in OP_REGISTRY.items():
    _fn = _make_op_func(_name, _op)
    setattr(_internal, _name, _fn)
    if not _name.startswith("_") and not hasattr(_this, _name):
        setattr(_this, _name, _fn)
sys.modules[__name__ + "._internal"] = _internal

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "invoke",
           "concatenate", "params_from_jax"]
