"""Gluon ``Parameter`` and ``ParameterDict``.

Counterpart of ``mxnet_tpu/gluon/parameter.py:38-399``: deferred
initialization (a shape dim of 0 is filled in from the first input),
``grad_req``, ``initialize``, ``data``/``grad``, ``cast`` and ``var``,
the stale-gradient flag ``_fresh_grad`` that backward sets and
``Trainer.step`` clears, and the prefixed registry ``ParameterDict``.
As in the JAX package a Parameter owns one NDArray on one context.
``cast`` gives the NDArray a new tensor of the new dtype (an in-place
copy would keep the old one).  Saving and loading parameter files waits
for ``nd.save``/``load``.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..base import MXNetError, torch_dtype
from ..context import Context, current_context
from .. import ndarray as nd
from .. import initializer
from .. import symbol as _sym
from .. import autograd

__all__ = ["DeferredInitializationError", "Parameter", "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """Raised when a parameter's value is requested before its shape is
    known."""


def _shape_known(shape):
    return shape is not None and all(s > 0 for s in shape)


class Parameter:
    """A weight of a Block; ``grad_req`` in {'write', 'add', 'null'}; shape
    dims of 0 are inferred at the first forward (deferred init)."""

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._grad_req = grad_req if differentiable else "null"
        self._data = None
        self._grad = None
        self._ctx_list = None
        self._deferred_init = ()

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, self.shape, self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("invalid grad_req %s" % req)
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null":
            self._grad = None
            if self._data is not None:
                self._data._data = self._data._data.detach()
                self._data._grad, self._data._marked = None, False
        elif self._data is not None:
            self._init_grad()

    # -- initialization ----------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Make the value on ``ctx`` (default: the current context, which
        raises with no card), or defer it until the shape is known."""
        if default_init is None:
            default_init = initializer.Uniform()
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        self._ctx_list = list(ctx)
        if not _shape_known(self.shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise ValueError("Cannot initialize Parameter %s because it has "
                             "invalid shape %s." % (self.name, self.shape))
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, init, ctx, default_init):
        self._deferred_init = ()
        data = nd.zeros(self.shape, ctx=ctx[0], dtype=self.dtype)
        initializer.create(init or self.init or default_init)(
            initializer.InitDesc(self.name), data)
        self._data = data
        if self._grad_req != "null":
            self._init_grad()

    def _init_grad(self):
        self._grad = nd.zeros(self.shape, ctx=self._data.context,
                              dtype=self._data._data.dtype)
        autograd.mark_variables([self._data], [self._grad],
                                grad_reqs=self._grad_req)

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        if not _shape_known(self.shape):
            raise DeferredInitializationError(
                "Parameter %s has unknown shape %s" % (self.name, self.shape))
        self._finish_init(*self._deferred_init)

    def _set_shape_if_deferred(self, shape):
        """Fill in inferred dims (0 -> concrete)."""
        if self.shape is None:
            self.shape = tuple(shape)
            return
        new = []
        for old, got in zip(self.shape, shape):
            if old > 0 and got > 0 and old != got:
                raise MXNetError(
                    "inferred shape %s incompatible with declared %s for %s"
                    % (shape, self.shape, self.name))
            new.append(old if old > 0 else got)
        self.shape = tuple(new)

    # -- stale-gradient tracking (mxnet_tpu/gluon/parameter.py:148-159) ---
    @property
    def _fresh_grad(self):
        """True when backward wrote this parameter's gradient since the
        last ``Trainer.step``."""
        return bool(self._data is not None and self._data._fresh_grad)

    @_fresh_grad.setter
    def _fresh_grad(self, value):
        if self._data is not None:
            self._data._fresh_grad = bool(value)

    # -- accessors ---------------------------------------------------------
    def _check_and_get(self, what="data"):
        if self._data is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    "Parameter %s has not been initialized yet because "
                    "initialization was deferred. Actual initialization "
                    "happens during the first forward pass." % self.name)
            raise RuntimeError(
                "Parameter %s has not been initialized. You should "
                "initialize parameters with Block.collect_params()."
                "initialize(...) before use." % self.name)
        return self._data if what == "data" else self._grad

    def data(self, ctx=None):
        return self._check_and_get("data")

    def grad(self, ctx=None):
        g = self._check_and_get("grad")
        if g is None:
            raise RuntimeError("Cannot get gradient array for Parameter %s "
                               "because grad_req='null'" % self.name)
        return g

    def set_data(self, data):
        """Set the value (finishing a deferred or missing init from its
        shape); ``data`` is an NDArray or an array-like."""
        if self._data is None:
            self._set_shape_if_deferred(data.shape)
            if self._deferred_init:
                self._finish_init(*self._deferred_init)
            else:
                self._finish_init(initializer.Zero(),
                                  self._ctx_list or [current_context()],
                                  initializer.Zero())
        if not isinstance(data, nd.NDArray):
            data = nd.array(data, ctx=self._data.context, dtype=self.dtype)
        self._data._set_data(data._data)

    def cast(self, dtype):
        """Cast the value (and its gradient buffer) to ``dtype``."""
        self.dtype = dtype
        if self._data is None:
            return
        dt = torch_dtype(dtype)
        self._data._data = self._data._data.detach().to(dt)
        if self._grad is not None:
            self._grad._data = self._grad._data.to(dt)
            autograd.mark_variables([self._data], [self._grad],
                                    grad_reqs=self._grad_req)

    def var(self):
        """A symbol variable standing for this parameter."""
        shape = self.shape if _shape_known(self.shape) else None
        return _sym.var(self.name, shape=shape, dtype=self.dtype,
                        lr_mult=self.lr_mult, wd_mult=self.wd_mult,
                        init=self.init)


class ParameterDict:
    """Parameters under a common name prefix."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        return "%s(\n%s\n)" % (self._prefix + " " if self._prefix else "",
                               "\n".join("  " + repr(p)
                                         for p in self._params.values()))

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, key):
        return key in self._params

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """The Parameter ``prefix + name``, made if it is not there yet."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                if v is not None:
                    setattr(param, k, v)
                continue
            if k == "shape" and v is not None and len(v) == len(existing):
                param.shape = tuple(e if e > 0 else n
                                    for e, n in zip(existing, v))
                continue
            if v is not None and v != existing:
                raise AssertionError(
                    "Cannot retrieve Parameter %s because desired attribute "
                    "%s does not match stored: %s vs %s"
                    % (name, k, v, existing))
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(
                    "Cannot update self with other because they have "
                    "different Parameters with the same name %s" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = initializer.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

