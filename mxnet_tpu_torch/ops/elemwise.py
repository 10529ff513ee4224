"""Elementwise operators: unary, binary, scalar, comparison and logical,
``Cast``, ``clip``, ``add_n``, ``softmax``/``log_softmax``/``softmin`` and
``where``.

Counterpart of ``mxnet_tpu/ops/elemwise.py``: the whole ``_UNARY`` table
(:26-52), ``_copy``/``identity``, ``BlockGrad``, ``make_loss``,
``smooth_l1``, ``softmin`` and ``clip`` (:57-140), the binary, scalar and
broadcast families with ``hypot`` and the logical ops, ``_grad_add``,
the ``_scatter_*`` dense forms (:149-192) and
``_identity_with_attr_like_rhs``.  Names and aliases are MXNet's:
``elemwise_add``/``_plus``/``broadcast_add``; scalar variants take the
attr ``scalar``; reverse variants are ``_r*``.

The formulas are the JAX package's, op for op: ``gamma`` is
``exp(lgamma(x))``, which is |Γ(x)| (its sign is wrong for negative
non-integers, as there); ``round`` and ``rint`` round half to even
(``jnp.round``), not half away from zero; ``fix`` is ``trunc``;
``rsqrt``/``rcbrt``/``reciprocal`` divide one by the root.  ``clip`` is a
``maximum`` then a ``minimum``, so its gradient at a bound splits as
``jnp.clip``'s does.  ``BlockGrad`` and ``make_loss`` keep the semantic
gradients (zeros; ones times ``grad_scale``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import register


def _max0(x):
    """``jnp.maximum(x, 0)``, whose gradient is 1/2 where x == 0; torch's
    ``maximum`` splits ties the same way (``clamp_min`` would not)."""
    return torch.maximum(x, x.new_zeros(()))


def _cbrt(x):
    """``jnp.cbrt``: the real cube root, negative for negative x."""
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    "abs": torch.abs,
    "arccos": torch.acos, "arccosh": torch.acosh,
    "arcsin": torch.asin, "arcsinh": torch.asinh,
    "arctan": torch.atan, "arctanh": torch.atanh,
    "cbrt": _cbrt, "ceil": torch.ceil,
    "cos": torch.cos, "cosh": torch.cosh,
    "degrees": torch.rad2deg, "exp": torch.exp, "expm1": torch.expm1,
    "fix": torch.trunc, "floor": torch.floor,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "log": torch.log, "log10": torch.log10, "log1p": torch.log1p,
    "log2": torch.log2,
    "negative": torch.neg,
    "radians": torch.deg2rad,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "reciprocal": lambda x: 1.0 / x,
    "relu": _max0,
    "rint": torch.round, "round": torch.round,
    "rsqrt": lambda x: 1.0 / torch.sqrt(x),
    "sigmoid": torch.sigmoid,
    "sign": torch.sign, "sin": torch.sin, "sinh": torch.sinh,
    "sqrt": torch.sqrt, "square": torch.square,
    "tan": torch.tan, "tanh": torch.tanh, "trunc": torch.trunc,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "softsign": F.softsign,
}


def _mk_unary(fn):
    return lambda x, **kw: fn(x)


for _n, _fn in _UNARY.items():
    register(_n)(_mk_unary(_fn))

register("_copy", aliases=["identity"])(lambda x, **kw: x)


def _block_grad_bwd(out_grads, inputs, outputs, attrs):
    return (torch.zeros_like(inputs[0]),)


register("BlockGrad", aliases=["stop_gradient"], custom_vjp=_block_grad_bwd)(
    lambda x, **kw: x.clone())


def _make_loss_bwd(out_grads, inputs, outputs, attrs):
    # the output is the loss: its gradient is ones, whatever the head
    return (torch.ones_like(inputs[0]) * attrs.get("grad_scale", 1.0),)


register("make_loss", custom_vjp=_make_loss_bwd)(lambda x, **kw: x.clone())


@register("smooth_l1")
def _smooth_l1(x, scalar=1.0, **kw):
    s2 = scalar * scalar
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)


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


@register("softmin")
def _softmin(x, axis=-1, **kw):
    return torch.softmax(-x, dim=axis)


@register("Cast", aliases=["cast"])
def _cast(x, dtype="float32", **kw):
    return x.to(torch_dtype(dtype))


@register("clip")
def _clip(x, a_min=None, a_max=None, **kw):
    if a_min is not None:
        x = torch.maximum(x, x.new_full((), a_min))
    if a_max is not None:
        x = torch.minimum(x, x.new_full((), a_max))
    return x


@register("where", nondiff_inputs=(0,))
def _where(cond, x, y, **kw):
    return torch.where(cond.to(torch.bool), x, y)


@register("add_n", aliases=["ElementWiseSum", "elemwise_sum",
                            "_sparse_add_n"])
def _add_n(*args, num_args=None, **kw):
    """Left to right, as the JAX package adds them."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("_identity_with_attr_like_rhs", nondiff_inputs=(1,))
def _id_attr_like(lhs, rhs, **kw):
    return lhs


# jnp.mod is the floor modulo (sign of the divisor): torch.remainder
_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.div, "mod": torch.remainder, "power": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum, "hypot": torch.hypot,
}
_CMP = {
    "equal": torch.eq, "not_equal": torch.ne,
    "greater": torch.gt, "greater_equal": torch.ge,
    "lesser": torch.lt, "lesser_equal": torch.le,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
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
    if _n in ("maximum", "minimum", "hypot"):
        _aliases.append(_n)
    register("elemwise_%s" % _n, aliases=_aliases)(_mk_binary(_fn))

for _n, _fn in _CMP.items():
    register("_%s" % _n, aliases=["broadcast_%s" % _n])(_mk_cmp(_fn))

register("_grad_add")(_mk_binary(torch.add))


def _full_as(x, s):
    return x.new_full((), s)


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
    "_maximum_scalar": lambda x, s: torch.maximum(x, _full_as(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, _full_as(x, s)),
    "_hypot_scalar": lambda x, s: torch.hypot(x, _full_as(x, s)),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
    "_logical_and_scalar": lambda x, s: torch.logical_and(
        x, _full_as(x, s)).to(x.dtype),
    "_logical_or_scalar": lambda x, s: torch.logical_or(
        x, _full_as(x, s)).to(x.dtype),
    "_logical_xor_scalar": lambda x, s: torch.logical_xor(
        x, _full_as(x, s)).to(x.dtype),
}


def _mk_scalar(fn):
    return lambda x, scalar=0.0, **kw: fn(x, scalar)


for _n, _fn in _SCALAR.items():
    register(_n)(_mk_scalar(_fn))

register("_scatter_plus_scalar")(_mk_scalar(lambda x, s: x + s))
register("_scatter_minus_scalar")(_mk_scalar(lambda x, s: x - s))
register("_scatter_elemwise_div")(_mk_binary(torch.div))

