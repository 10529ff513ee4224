"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (``InitDesc``, the
``Initializer`` dispatch protocol, ``create`` and the ``Registry`` of
names, ``Zero``/``One``, ``Constant``, ``Uniform``, ``Normal``,
``Orthogonal`` :181-198, ``Xavier``, ``MSRAPrelu`` and ``Bilinear``
:238-259, ``LSTMBias``, ``FusedRNN``, ``Load`` and ``Mixed`` :298-345,
and the ``init`` namespace).
A variable's ``__init__`` attr (``"zeros"``, ``"ones"``, or an
initializer's ``dumps()``) wins; else the name decides the handler:
``*_weight`` takes the initializer's draw, ``*_bias``/``*_beta`` and
``running_mean``/``moving_mean`` zeros, ``*_gamma`` and
``running_var``/``moving_var`` ones.
Draws are made on the host by the numpy generator ``random.host_rng()``,
with the JAX package's calls in its order (``uniform(-s, s, shape)``,
``normal(0, sigma, shape)``; ``Orthogonal``'s draw and its numpy SVD),
and written into the array once (``arr[:] = draw``, one copy to its
device): after ``random.seed(n)`` in both packages a seeded initializer
gives the JAX package's weights.  ``Bilinear``'s kernel is made on the
host too, so every device gets the same bits.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np

from .base import MXNetError, Registry
from . import ndarray as nd
from . import random as _random

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Constant", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "LSTMBias", "FusedRNN", "Load", "Mixed",
           "init"]

_REG = Registry("initializer")


def register(klass, name=None):
    _REG.register(klass, name)
    return klass


def create(name, **kwargs):
    """An initializer from a registered name (``"zeros"``, ``"xavier"``),
    its ``dumps()`` JSON ``[class, kwargs]``, or the instance itself (or
    any other callable)."""
    if isinstance(name, Initializer) or callable(name) \
            and not isinstance(name, (str, type)):
        return name
    if isinstance(name, str) and name.lstrip().startswith("["):
        name, kwargs = json.loads(name)
    return _REG.get(str(name))(**kwargs)


class InitDesc(str):
    """Parameter name enriched with its symbol attrs and the global
    initializer."""

    def __new__(cls, name, attrs=None, global_init=None):
        self = super().__new__(cls, name)
        self.attrs = attrs or {}
        self.global_init = global_init
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
        self._verbose, self._print_func = False, None

    def set_verbosity(self, verbose=False, print_func=None):
        self._verbose, self._print_func = verbose, print_func
        return self

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        if desc.global_init is None:
            desc.global_init = self
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
class Constant(Initializer):
    """Every element ``value``."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value
    _init_default = _init_weight


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
class Orthogonal(Initializer):
    """``scale`` times an orthonormal basis of a (rows, rest) draw,
    uniform in [-1, 1) or standard normal, from its numpy SVD."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale, self.rand_type = scale, rand_type

    def _init_weight(self, _, arr):
        rows = arr.shape[0]
        cols = int(np.prod(arr.shape[1:]))
        rng = _random.host_rng()
        draw = (rng.uniform(-1.0, 1.0, (rows, cols))
                if self.rand_type == "uniform"
                else rng.normal(0.0, 1.0, (rows, cols)))
        u, _s, v = np.linalg.svd(draw, full_matrices=False)
        basis = u if u.shape == draw.shape else v
        arr[:] = (self.scale * basis).reshape(arr.shape)


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


@register
class MSRAPrelu(Xavier):
    """He's initialization for a PReLU of slope ``slope``: Gaussian
    Xavier of magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a ``Deconvolution`` (fp32, the
    same in every channel)."""

    def _init_weight(self, _, arr):
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        xs = np.arange(shape[3], dtype="float32")
        ys = np.arange(shape[2], dtype="float32")
        kernel = np.outer(1 - np.abs(ys / f - c), 1 - np.abs(xs / f - c))
        arr[:] = np.broadcast_to(kernel, shape).astype("float32")


@register
class LSTMBias(Initializer):
    """Zeros but the forget gate (the second quarter: gates i,f,g,o),
    which is ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        per_gate = arr.shape[0] // 4
        host = np.zeros(arr.shape, dtype="float32")
        host[per_gate:2 * per_gate] = self.forget_bias
        arr[:] = host
    _init_default = _init_weight
    _init_bias = _init_weight


@register
class FusedRNN(Initializer):
    """The packed vector of a fused RNN, drawn whole by ``init`` (an
    initializer, its name or its ``dumps()``; default ``Uniform(0.1)``),
    as the JAX package draws it: the packed layout needs no re-packing."""

    def __init__(self, init=None, state_size=None, num_layers=None,
                 mode=None, bidirectional=False, forget_bias=1.0):
        super().__init__()
        if isinstance(init, Initializer):
            self._init = init
        elif isinstance(init, str) and init:
            self._init = create(init)
        else:
            self._init = Uniform(0.1)

    def _init_weight(self, desc, arr):
        self._init._init_weight(desc, arr)
    _init_default = _init_weight


@register
class Load:
    """The values of a saved dict (a file name or {name: NDArray}; an
    ``arg:``/``aux:`` tag dropped), else ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            param = nd.load(param)
        self.param = {key.split(":", 1)[-1]: val
                      for key, val in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        loaded = self.param.get(name)
        if loaded is not None:
            if tuple(loaded.shape) != tuple(arr.shape):
                raise MXNetError(
                    "Parameter %s cannot be initialized from loading. Shape "
                    "mismatch, target %s vs loaded %s"
                    % (name, arr.shape, loaded.shape))
            loaded.copyto(arr)
            return
        if self.default_init is None:
            raise MXNetError(
                "Cannot Initialize parameter %s. Not found in loaded "
                "param and no default initializer" % name)
        self.default_init(name, arr)


@register
class Mixed:
    """The initializer of the first of ``patterns`` (regular expressions)
    that the name matches."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must have same length")
        self.map = [(re.compile(p), i)
                    for p, i in zip(patterns, initializers)]

    def __call__(self, name, arr):
        for matcher, initializer in self.map:
            if matcher.match(name):
                initializer(name, arr)
                return
        raise ValueError(
            'Parameter name %s did not match any pattern. Consider adding a '
            '".*" pattern at the end with default Initializer.' % name)


class _InitModule:
    """The ``init`` namespace: the initializer classes by name."""
    Initializer, InitDesc = Initializer, InitDesc
    Zero, One, Constant = Zero, One, Constant
    Uniform, Normal, Orthogonal = Uniform, Normal, Orthogonal
    Xavier, MSRAPrelu, Bilinear = Xavier, MSRAPrelu, Bilinear
    LSTMBias, FusedRNN = LSTMBias, FusedRNN
    Load, Mixed = Load, Mixed


init = _InitModule()
