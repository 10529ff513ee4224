"""``nd.random``: sampling from the distributions by name.

Counterpart of ``mxnet_tpu/ndarray/random.py:1-82``.  A parameter given
as an NDArray takes the ``_sample_*`` op (one distribution per element
of the parameter, ``shape`` draws each); scalars take the ``_random_*``
op on ``ctx`` (default: the current context).  Draws come from that
device's generator (``random.generator``).
"""
from __future__ import annotations

from .ndarray import invoke, NDArray
from ..ops.registry import get_op

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "randint", "shuffle"]


def _sample(op_shape, op_tensor, params, shape, dtype, ctx, out, kwargs):
    if any(isinstance(p, NDArray) for p in params):
        nd_params = [p for p in params if isinstance(p, NDArray)]
        attrs = dict(shape=shape if shape is not None else (),
                     dtype=dtype or "float32", **kwargs)
        return invoke(get_op(op_tensor), nd_params, attrs, out=out)[0]
    attrs = dict(shape=shape if shape is not None else (1,),
                 dtype=dtype or "float32", ctx=ctx, **kwargs)
    return invoke(get_op(op_shape), [], attrs, out=out)[0]


def _tensor(*params):
    return any(isinstance(p, NDArray) for p in params)


def uniform(low=0, high=1, shape=None, dtype=None, ctx=None, out=None, **kw):
    if _tensor(low, high):
        return _sample(None, "_sample_uniform", [low, high], shape, dtype,
                       ctx, out, {})
    return _sample("_random_uniform", None, [], shape, dtype, ctx, out,
                   dict(low=float(low), high=float(high)))


def normal(loc=0, scale=1, shape=None, dtype=None, ctx=None, out=None, **kw):
    if _tensor(loc, scale):
        return _sample(None, "_sample_normal", [loc, scale], shape, dtype,
                       ctx, out, {})
    return _sample("_random_normal", None, [], shape, dtype, ctx, out,
                   dict(loc=float(loc), scale=float(scale)))


def gamma(alpha=1, beta=1, shape=None, dtype=None, ctx=None, out=None, **kw):
    if _tensor(alpha, beta):
        return _sample(None, "_sample_gamma", [alpha, beta], shape, dtype,
                       ctx, out, {})
    return _sample("_random_gamma", None, [], shape, dtype, ctx, out,
                   dict(alpha=float(alpha), beta=float(beta)))


def exponential(scale=1, shape=None, dtype=None, ctx=None, out=None, **kw):
    if _tensor(scale):
        return _sample(None, "_sample_exponential", [scale], shape, dtype,
                       ctx, out, {})
    return _sample("_random_exponential", None, [], shape, dtype, ctx, out,
                   dict(lam=1.0 / float(scale)))


def poisson(lam=1, shape=None, dtype=None, ctx=None, out=None, **kw):
    if _tensor(lam):
        return _sample(None, "_sample_poisson", [lam], shape, dtype, ctx,
                       out, {})
    return _sample("_random_poisson", None, [], shape, dtype, ctx, out,
                   dict(lam=float(lam)))


def negative_binomial(k=1, p=1, shape=None, dtype=None, ctx=None, out=None,
                      **kw):
    return _sample("_random_negative_binomial", None, [], shape, dtype, ctx,
                   out, dict(k=int(k), p=float(p)))


def generalized_negative_binomial(mu=1, alpha=1, shape=None, dtype=None,
                                  ctx=None, out=None, **kw):
    return _sample("_random_generalized_negative_binomial", None, [], shape,
                   dtype, ctx, out, dict(mu=float(mu), alpha=float(alpha)))


def multinomial(data, shape=None, get_prob=False, out=None, dtype="int32",
                **kw):
    """Class indices drawn from the probabilities along ``data``'s last
    axis; with ``get_prob`` also their log-probabilities."""
    attrs = dict(shape=shape or (), get_prob=get_prob, dtype=dtype)
    res = invoke(get_op("_sample_multinomial"), [data], attrs, out=out)
    return res if get_prob else res[0]


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None, **kw):
    return _sample("_random_randint", None, [], shape, dtype, ctx, out,
                   dict(low=int(low), high=int(high)))


def shuffle(data, **kw):
    """``data``'s rows in a random order."""
    return invoke(get_op("shuffle"), [data], {})[0]
