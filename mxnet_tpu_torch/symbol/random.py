"""``sym.random``: sampling nodes of a graph.

Counterpart of ``mxnet_tpu/symbol/random.py:1-25``: each function makes a
``_random_*`` node with no inputs, whose draw comes from the generator
of the device the graph runs on.
"""
from __future__ import annotations

from .symbol import Symbol

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson"]


def _mk(opname, params):
    def f(*args, shape=None, dtype=None, **kw):
        attrs = dict(zip(params, args))
        attrs.update({k: v for k, v in kw.items()
                      if not isinstance(v, Symbol) and k != "name"})
        attrs["shape"] = shape
        if dtype:
            attrs["dtype"] = str(dtype)
        return Symbol._from_op(opname, [], attrs, name=kw.get("name"))
    f.__name__ = opname
    return f


uniform = _mk("_random_uniform", ["low", "high"])
normal = _mk("_random_normal", ["loc", "scale"])
gamma = _mk("_random_gamma", ["alpha", "beta"])
exponential = _mk("_random_exponential", ["lam"])
poisson = _mk("_random_poisson", ["lam"])
