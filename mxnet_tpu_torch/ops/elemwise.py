"""Elementwise operators: unary, binary, scalar and comparison, ``Cast``,
``add_n``, ``softmax``/``log_softmax`` and ``where``.

Counterpart of ``mxnet_tpu/ops/elemwise.py``, reduced to the ops the
NDArray and Symbol operators dispatch to (``ndarray.py:360-427``,
``symbol.py:194-232``), the unary math the Gluon losses use (``_UNARY``
:27: ``abs``, ``exp``, ``log``, ``sigmoid``, ``square``), ``relu``,
``softmax``:83 and ``log_softmax``:90 along ``axis``, ``Cast``:102,
``add_n``/``ElementWiseSum``:195 and ``where``:213.  Names and aliases
are MXNet's: ``elemwise_add``/``_plus``/``broadcast_add``; scalar
variants take the attr ``scalar``; reverse variants are ``_r*``.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register


def _max0(x):
    """``jnp.maximum(x, 0)``, whose gradient is 1/2 where x == 0; torch's
    ``maximum`` splits ties the same way (``clamp_min`` would not)."""
    return torch.maximum(x, x.new_zeros(()))


register("relu")(lambda x, **kw: _max0(x))
register("negative")(lambda x, **kw: torch.neg(x))

_UNARY = {"abs": torch.abs, "exp": torch.exp, "log": torch.log,
          "sigmoid": torch.sigmoid, "square": torch.square}


def _mk_unary(fn):
    return lambda x, **kw: fn(x)


for _n, _fn in _UNARY.items():
    register(_n)(_mk_unary(_fn))


def _tempered(x, temperature):
    if temperature is not None and temperature != 1.0:
        return x / temperature
    return x


@register("softmax")
def _softmax(x, axis=-1, temperature=None, **kw):
    return torch.softmax(_tempered(x, temperature), dim=axis)


@register("log_softmax")
def _log_softmax(x, axis=-1, temperature=None, **kw):
    return torch.log_softmax(_tempered(x, temperature), dim=axis)


@register("where", nondiff_inputs=(0,))
def _where(cond, x, y, **kw):
    return torch.where(cond.to(torch.bool), x, y)


@register("Cast", aliases=["cast"])
def _cast(x, dtype="float32", **kw):
    return x.to(torch_dtype(dtype))


@register("add_n", aliases=["ElementWiseSum", "elemwise_sum"])
def _add_n(*args, num_args=None, **kw):
    """Left to right, as the JAX package adds them."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


# jnp.mod is the floor modulo (sign of the divisor): torch.remainder
_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.div, "mod": torch.remainder, "power": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum,
}
_CMP = {
    "equal": torch.eq, "not_equal": torch.ne,
    "greater": torch.gt, "greater_equal": torch.ge,
    "lesser": torch.lt, "lesser_equal": torch.le,
}
_OLD_NAMES = {"add": "_plus", "sub": "_minus", "mul": "_mul", "div": "_div"}


def _mk_binary(fn):
    return lambda a, b, **kw: fn(a, b)


def _mk_cmp(fn):
    return lambda a, b, **kw: fn(a, b).to(a.dtype)


for _n, _fn in _BINARY.items():
    _aliases = ["broadcast_%s" % _n, "_%s" % _n]
    if _n in _OLD_NAMES:
        _aliases.append(_OLD_NAMES[_n])
    if _n in ("maximum", "minimum"):
        _aliases.append(_n)
    register("elemwise_%s" % _n, aliases=_aliases)(_mk_binary(_fn))

for _n, _fn in _CMP.items():
    register("_%s" % _n, aliases=["broadcast_%s" % _n])(_mk_cmp(_fn))

_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(torch.full_like(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.maximum(x, x.new_full((), s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, x.new_full((), s)),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
}


def _mk_scalar(fn):
    return lambda x, scalar=0.0, **kw: fn(x, scalar)


for _n, _fn in _SCALAR.items():
    register(_n)(_mk_scalar(_fn))
