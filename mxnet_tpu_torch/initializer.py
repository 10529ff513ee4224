"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py:26-240`` (``InitDesc``, the
``Initializer`` dispatch protocol, ``create`` and the registered names,
``Zero``/``One``, ``Uniform``, ``Normal``, ``Xavier``).
A variable's ``__init__`` attr (``"zeros"``, ``"ones"``, or an
initializer's ``dumps()``) wins; else the name decides the handler:
``*_weight`` takes the initializer's draw, ``*_bias``/``*_beta`` and
``running_mean``/``moving_mean`` zeros, ``*_gamma`` and
``running_var``/``moving_var`` ones.
Draws are made on the host by the numpy generator ``random.host_rng()``,
with the JAX package's calls in its order (``uniform(-s, s, shape)``,
``normal(0, sigma, shape)``), and written into the array once
(``arr[:] = draw``, one copy to its device): after ``random.seed(n)`` in
both packages a seeded initializer gives the JAX package's weights.
"""
from __future__ import annotations

import json
import math

from .base import MXNetError
from . import random as _random

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Uniform", "Normal", "Xavier"]

_REGISTRY = {}


def register(klass, name=None):
    _REGISTRY[(name or klass.__name__).lower()] = klass
    return klass


def create(name, **kwargs):
    """An initializer from a registered name (``"zeros"``, ``"xavier"``),
    its ``dumps()`` JSON ``[class, kwargs]``, or the instance itself."""
    if isinstance(name, Initializer):
        return name
    if isinstance(name, str) and name.lstrip().startswith("["):
        name, kwargs = json.loads(name)
    key = str(name).lower()
    if key not in _REGISTRY:
        raise MXNetError("Cannot find initializer '%s'. Registered: %s"
                         % (name, sorted(_REGISTRY)))
    return _REGISTRY[key](**kwargs)


class InitDesc(str):
    """Parameter name enriched with its symbol attrs."""

    def __new__(cls, name, attrs=None):
        self = super().__new__(cls, name)
        self.attrs = attrs or {}
        return self


# (name suffix -> handler method) dispatch table, checked in order
_SUFFIX_DISPATCH = (
    (("weight",), "_init_weight"),
    (("bias",), "_init_bias"),
    (("gamma",), "_init_gamma"),
    (("beta",), "_init_beta"),
    (("moving_mean", "running_mean", "moving_inv_var", "moving_avg",
      "min", "max"), "_init_zero"),
    (("moving_var", "running_var"), "_init_one"),
)


class Initializer:
    """Base initializer: a variable's ``__init__`` attr, else the name
    suffix, picks the handler."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        attr_init = desc.attrs.get("__init__", "")
        if attr_init:
            create(attr_init)._init_weight(desc, arr)
            return
        lowered = desc.lower()
        for suffixes, handler in _SUFFIX_DISPATCH:
            if lowered.endswith(suffixes):
                getattr(self, handler)(desc, arr)
                return
        self._init_default(desc, arr)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    _init_bias = _init_zero
    _init_beta = _init_zero
    _init_gamma = _init_one

    def _init_weight(self, name, arr):
        raise NotImplementedError()

    def _init_default(self, name, arr):
        raise ValueError(
            'Unknown initialization pattern for %s. Default initialization '
            'is limited to "weight", "bias", "gamma", and "beta"' % name)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0
    _init_default = _init_weight


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0
    _init_default = _init_weight


register(Zero, "zeros")
register(One, "ones")


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = _random.host_rng().uniform(-self.scale, self.scale,
                                            arr.shape)


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = _random.host_rng().normal(0, self.sigma, arr.shape)


@register
class Xavier(Initializer):
    """Glorot init: scale^2 = magnitude / factor(fan_in, fan_out)."""

    _FACTORS = {"avg": lambda fi, fo: (fi + fo) / 2.0,
                "in": lambda fi, fo: fi,
                "out": lambda fi, fo: fo}

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type, self.factor_type = rnd_type, factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier initializer cannot be applied to vector "
                             "%s. It requires at least 2D." % name)
        if self.factor_type not in self._FACTORS:
            raise ValueError("Incorrect factor type")
        spatial = math.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * spatial, shape[0] * spatial
        sigma = math.sqrt(self.magnitude
                          / self._FACTORS[self.factor_type](fan_in, fan_out))
        if self.rnd_type == "uniform":
            arr[:] = _random.host_rng().uniform(-sigma, sigma, arr.shape)
        elif self.rnd_type == "gaussian":
            arr[:] = _random.host_rng().normal(0, sigma, arr.shape)
        else:
            raise ValueError("Unknown random type")
