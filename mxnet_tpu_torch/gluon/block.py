"""Gluon ``Block`` and ``HybridBlock``.

Counterpart of ``mxnet_tpu/gluon/block.py`` (name scopes ``:42-82``,
``Block`` ``:111``, ``HybridBlock`` ``:210``, its ``infer_shape``
``:250`` and ``forward`` ``:280``).  A HybridBlock's ``hybrid_forward``
runs on NDArrays through ``nd`` (the imperative path) or on Symbols
through ``sym`` (``net(sym.var("data"))`` lowers the network to a
graph, as ``Module`` takes it).  Deferred parameter shapes are filled in
by symbolic shape inference on the first input.

``hybridize()`` keeps its flag and the imperative path: the JAX
package's cached op (one compiled program per block, ``:327``) has no
counterpart here yet.
"""
from __future__ import annotations

import threading

from .. import ndarray as nd
from ..ndarray import NDArray
from .. import symbol as _sym
from ..symbol import Symbol
from .. import autograd
from .. import name as _name
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock"]


class _BlockScope:
    """Name manager of Block construction: a child made inside a block's
    ``name_scope()`` takes the prefix ``<parent prefix><alias><n>_``,
    counted per alias in that scope; a top-level block counts in the
    symbol ``NameManager``."""
    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _name.current().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        _BlockScope._current.value = self._old_scope


def _flatten(args):
    """Nested lists of NDArrays/Symbols -> (flat list, format tree)."""
    if not isinstance(args, (list, tuple)):
        return [args], 0
    flat, fmts = [], []
    for a in args:
        f, fmt = _flatten(a)
        flat.extend(f)
        fmts.append(fmt)
    return flat, fmts


def _regroup(flat, fmt):
    if isinstance(fmt, int):
        return flat[0], flat[1:]
    ret = []
    for f in fmt:
        r, flat = _regroup(flat, f)
        ret.append(r)
    return ret, flat


class Block:
    """Base of every layer and model: children assigned as attributes are
    registered, and ``collect_params`` walks the tree."""

    def __init__(self, prefix=None, params=None):
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = []

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            self.register_child(value)
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self):
        """A ParameterDict of this block's and its children's params."""
        ret = ParameterDict(self._params.prefix)
        ret.update(self.params)
        for child in self._children:
            ret.update(child.collect_params())
        return ret

    def register_child(self, block):
        self._children.append(block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the current
        context; with no card that raises)."""
        if init is None:
            from .. import initializer
            init = initializer.Uniform()
        self.collect_params().initialize(init, ctx, verbose,
                                         force_reinit=force_reinit)

    def hybridize(self, active=True):
        for child in self._children:
            child.hybridize(active)

    def cast(self, dtype):
        for child in self._children:
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A Block whose ``hybrid_forward(F, x, *, <params>)`` is written
    against ``F = nd`` or ``F = sym``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._reg_params = {}

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, Parameter):
            assert name not in self._reg_params or \
                self._reg_params[name] is value, \
                "Overriding Parameter attribute %s is not allowed." % name
            self._reg_params[name] = value

    def register_child(self, block):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s "
                "has type %s." % (block, type(block)))
        super().register_child(block)

    def hybridize(self, active=True):
        self._active = active
        super().hybridize(active)

    def infer_shape(self, *args):
        """Fill in deferred parameter shapes by symbolic shape inference on
        the shapes of ``args``."""
        params = {p.name: p for p in self.collect_params().values()}
        flat_args, in_fmt = _flatten(list(args))
        flat_vars = [_sym.var("data%d" % i) for i in range(len(flat_args))]
        arg_tree, _ = _regroup(list(flat_vars), in_fmt)
        pkw = {name: p.var() for name, p in self._reg_params.items()}
        with autograd.pause():
            out = self.hybrid_forward(_sym, *arg_tree, **pkw)
        flat_out, _ = _flatten(out)
        out = flat_out[0] if len(flat_out) == 1 else _sym.Group(flat_out)
        arg_shapes, _, aux_shapes = out.infer_shape_partial(
            **{"data%d" % i: a.shape for i, a in enumerate(flat_args)})
        for name, shape in list(zip(out.list_arguments(), arg_shapes)) + \
                list(zip(out.list_auxiliary_states(), aux_shapes)):
            if name in params and shape is not None:
                params[name]._set_shape_if_deferred(shape)

    def _finish_deferred(self, *args):
        self.infer_shape(*args)
        for p in self.collect_params().values():
            p._finish_deferred_init()

    def forward(self, x, *args):
        if isinstance(x, NDArray):
            try:
                params = {k: p.data() for k, p in self._reg_params.items()}
            except DeferredInitializationError:
                self._finish_deferred(x, *args)
                params = {k: p.data() for k, p in self._reg_params.items()}
            return self.hybrid_forward(nd, x, *args, **params)
        if not isinstance(x, Symbol):
            raise ValueError("HybridBlock input must be NDArray or Symbol, "
                             "got %s" % type(x))
        pkw = {k: p.var() for k, p in self._reg_params.items()}
        return self.hybrid_forward(_sym, x, *args, **pkw)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
