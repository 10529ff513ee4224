"""``Module``: a symbol bound on a context and trained with an optimizer.

Counterpart of ``mxnet_tpu/module/module.py:36`` (``bind`` :262,
``init_params`` :203, ``get_params``/``set_params`` :183/:240,
``init_optimizer`` :356, ``forward``/``backward``/``update``
:424-:538, ``_fit_step`` :453, ``_get_cached_step`` :474,
``update_metric`` :549).  The module keeps host copies of the
parameters (NDArrays on ``cpu()``, as MXNet does) and the bound copies
on its context; ``update`` marks the host copies stale, and
``get_params`` brings them up to date.  ``_fit_step`` does forward,
backward and the update of every parameter in one call through
``cached_step.CachedTrainStep``, unless ``MXNET_MODULE_FUSED_STEP=0``
or the setup does not allow it; then it calls ``forward_backward`` and
``update``.

:func:`params_from_jax` carries the JAX package's ``get_params()`` over
as numpy arrays.  One context only (the kvstore slice is not ported);
checkpoints, ``reshape`` caching and monitors are not ported yet.
"""
from __future__ import annotations

import logging
import os
import warnings
from collections import OrderedDict

import numpy as np

from ..base import MXNetError, dtype_name
from .. import context as ctx_mod
from .. import ndarray as nd
from .. import optimizer as opt
from ..initializer import Uniform, InitDesc
from ..io import DataDesc
from .base_module import BaseModule, _check_input_names
from .cached_step import CachedTrainStep, fused_step_enabled
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module", "params_from_jax"]


def _as_descs(shapes):
    if shapes is None:
        return None
    return [s if isinstance(s, DataDesc) else DataDesc(*s) for s in shapes]


class Module(BaseModule):
    """A symbol with its data, label and parameter names, bound on one
    context (default: the current context, ``gpu(0)``; with no card
    that raises)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, fixed_param_names=None):
        super().__init__(logger=logger)
        ctxs = context if context is not None \
            else ctx_mod.current_context()
        if isinstance(ctxs, ctx_mod.Context):
            ctxs = [ctxs]
        self._context = [ctx_mod.as_context(c) for c in ctxs]
        self._symbol = symbol
        args = symbol.list_arguments()
        self._data_names = list(data_names or [])
        self._label_names = [n for n in (label_names or []) if n in args]
        inputs = set(self._data_names) | set(label_names or [])
        self._param_names = [a for a in args if a not in inputs]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        _check_input_names(symbol, self._data_names, "data")
        self._arg_params = self._aux_params = None
        self._params_dirty = False
        self._optimizer = self._updater = None
        self._cached_step, self._cached_step_unusable = None, False
        self._exec_group = self._data_shapes = self._label_shapes = None

    output_names = property(lambda self: self._output_names)
    data_names = property(lambda self: self._data_names)
    label_names = property(lambda self: self._label_names)

    @property
    def data_shapes(self):
        self._require_bound()
        return self._data_shapes

    @property
    def label_shapes(self):
        self._require_bound()
        return self._label_shapes

    def _require_bound(self):
        if not self.binded:
            raise AssertionError("module is not bound")

    # -- parameters ----------------------------------------------------------
    def get_params(self):
        self._require_ready()
        if self._params_dirty:
            self._exec_group.get_params(self._arg_params, self._aux_params)
            self._params_dirty = False
        return self._arg_params, self._aux_params

    def _alloc_host_params(self):
        proto = self._exec_group.execs[0]
        if self._arg_params is None:
            self._arg_params = {
                n: nd.zeros(proto.arg_dict[n].shape, ctx=ctx_mod.cpu(),
                            dtype=proto.arg_dict[n]._data.dtype)
                for n in self._param_names}
        if self._aux_params is None:
            self._aux_params = {
                n: nd.zeros(proto.aux_dict[n].shape, ctx=ctx_mod.cpu(),
                            dtype=proto.aux_dict[n]._data.dtype)
                for n in self._aux_names}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Fill the parameters from ``arg_params``/``aux_params`` or with
        ``initializer`` (default ``Uniform(0.01)``); a name missing from a
        given dict raises unless ``allow_missing``."""
        if self.params_initialized and not force_init:
            warnings.warn("init_params ignored: already initialized "
                          "(pass force_init=True to override)", stacklevel=2)
            return
        self._require_bound()
        if initializer is None:
            initializer = Uniform(0.01)
        self._alloc_host_params()
        attrs = self._symbol.attr_dict()
        for target, source in ((self._arg_params, arg_params),
                               (self._aux_params, aux_params)):
            for name in sorted(target):
                arr = target[name]
                if source is None:
                    initializer(InitDesc(name, attrs.get(name)), arr)
                elif name in source:
                    if source[name] is not arr:
                        source[name].copyto(arr)
                elif allow_missing:
                    initializer(InitDesc(name, attrs.get(name)), arr)
                else:
                    raise RuntimeError("%s is not presented" % name)
        self.params_initialized, self._params_dirty = True, False
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)

    # -- binding -------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write"):
        """Bind an executor for these input shapes (and dtypes, from each
        ``DataDesc``)."""
        if force_rebind:
            self.binded, self._exec_group = False, None
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self._data_shapes = _as_descs(data_shapes)
        self._label_shapes = _as_descs(label_shapes)
        self._exec_group = self._make_exec_group()
        self._reshape_cache = OrderedDict({self._shape_key():
                                           self._exec_group})
        self.binded = True
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def _make_exec_group(self):
        self._cached_step = None
        return DataParallelExecutorGroup(
            self._symbol, self._context, self._data_shapes,
            self._label_shapes, self._param_names, self.for_training,
            self.inputs_need_grad, fixed_param_names=self._fixed_param_names,
            grad_req=self._grad_req)

    def _shape_key(self):
        return tuple((d.name, tuple(d.shape), str(d.dtype))
                     for d in (self._data_shapes or [])
                     + (self._label_shapes or []))

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind for new input shapes, keeping the parameters.  The
        executor groups of recent shapes are kept (at most
        ``MXNET_MODULE_RESHAPE_CACHE``, default 8, the least recently used
        dropped first), each with its train step and captured programs,
        so alternating shapes rebind nothing (reference
        ``mxnet_tpu/module/module.py:329-352``)."""
        self._require_bound()
        self._data_shapes = _as_descs(data_shapes)
        self._label_shapes = _as_descs(label_shapes)
        key = self._shape_key()
        group = self._reshape_cache.pop(key, None)
        if group is None:
            group = self._make_exec_group()
            limit = max(int(os.environ.get("MXNET_MODULE_RESHAPE_CACHE",
                                           "8")), 1)
            while len(self._reshape_cache) >= limit:
                self._reshape_cache.popitem(last=False)
        self._reshape_cache[key] = group
        self._exec_group = group
        self._cached_step = getattr(group, "cached_step", None)
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def _maybe_reshape(self, data_batch):
        """Rebind when a batch's shapes differ from the bound ones."""
        bound = tuple(d.shape for d in self._data_shapes)
        incoming = tuple(x.shape for x in data_batch.data)
        if bound == incoming:
            return
        if self._params_dirty and self.params_initialized:
            self.get_params()
        new_data = data_batch.provide_data or [
            DataDesc(d.name, shp, d.dtype, d.layout)
            for d, shp in zip(self._data_shapes, incoming)]
        new_label = data_batch.provide_label
        if not new_label and data_batch.label:
            new_label = [DataDesc(d.name, arr.shape, d.dtype, d.layout)
                         for d, arr in zip(self._label_shapes,
                                           data_batch.label)]
        self.reshape(new_data, new_label or None)

    # -- optimizer -----------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Make the optimizer (``rescale_grad`` defaults to 1 / batch) and
        its Updater.  One context takes no kvstore: ``"local"`` and
        ``"device"`` mean none, a distributed one raises."""
        self._require_ready()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if kvstore is not None and not (isinstance(kvstore, str) and kvstore
                                        in ("local", "device")):
            raise MXNetError("kvstore %r: the kvstore slice is not ported "
                             "yet" % (kvstore,))
        if isinstance(optimizer, str):
            kwargs = dict(optimizer_params)
            kwargs.setdefault("rescale_grad",
                              1.0 / self._exec_group.batch_size)
            optimizer = opt.create(
                optimizer, sym=self._symbol, param_idx2name=dict(
                    enumerate(self._exec_group.param_names)), **kwargs)
        elif not isinstance(optimizer, opt.Optimizer):
            raise TypeError("optimizer must be a name or an Optimizer")
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self._cached_step, self._cached_step_unusable = None, False
        self.optimizer_initialized = True

    # -- computation ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        self._require_ready()
        self._maybe_reshape(data_batch)
        self._exec_group.forward(data_batch, is_train)

    def forward_backward(self, data_batch):
        self._require_ready()
        self._maybe_reshape(data_batch)
        self._exec_group.forward_backward(data_batch)

    def backward(self, out_grads=None):
        self._require_ready()
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """One optimizer update of every parameter that has a gradient."""
        if not self.optimizer_initialized:
            raise AssertionError("init_optimizer must run before update")
        self._require_ready()
        self._params_dirty = True
        group = self._exec_group
        for slot, (weights, grads) in enumerate(zip(group.param_arrays,
                                                    group.grad_arrays)):
            if grads is not None:
                self._updater(slot, grads[0], weights[0])

    def _fit_step(self, data_batch):
        """Forward, backward and update: in one call through the cached
        train step where the setup allows it, else the two-call path."""
        self._maybe_reshape(data_batch)
        step = self._get_cached_step()
        if step is None:
            super()._fit_step(data_batch)
            return
        feed = dict(zip(self._data_names, data_batch.data))
        if data_batch.label:
            feed.update(zip(self._label_names, data_batch.label))
        step.run(feed)
        self._params_dirty = True

    def _get_cached_step(self):
        if self._cached_step_unusable or not fused_step_enabled() \
                or not self.optimizer_initialized or self.inputs_need_grad:
            return None
        ex = self._exec_group.execs[0]
        if any(r not in ("write", "null") for r in ex.grad_req.values()):
            return None
        step = self._cached_step
        if step is not None and step._exec is ex \
                and step._updater is self._updater:
            return step
        try:
            self._cached_step = CachedTrainStep(
                ex, self._updater, self._exec_group.param_names)
        except ValueError:
            self._cached_step, self._cached_step_unusable = None, True
        self._exec_group.cached_step = self._cached_step
        return self._cached_step

    def get_outputs(self, merge_multi_context=True):
        self._require_ready()
        return self._exec_group.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)


def params_from_jax(arg_params, aux_params, symbol, ctx=None,
                    data_shapes=None):
    """The JAX package's ``Module.get_params()`` dicts, given as numpy
    arrays (``{n: v.asnumpy()}``; bfloat16 as ``ml_dtypes.bfloat16``),
    as NDArrays on ``ctx`` (default: the current context) for
    ``Module.set_params``.

    Every name must be a parameter argument or an aux state of
    ``symbol``, and every aux state must be given.  Each array's shape
    and dtype are checked against what ``simple_bind`` would allocate
    for it: with ``data_shapes`` (the ``DataDesc`` list given to
    ``Module.bind``) that is every array; without, the variables whose
    shape the symbol states.  A mismatch raises :class:`MXNetError`."""
    ctx = ctx_mod.as_context(ctx)
    args = symbol.list_arguments()
    auxs = symbol.list_auxiliary_states()
    extra = sorted(set(arg_params) - set(args)) \
        + sorted(set(aux_params) - set(auxs))
    missing = sorted(set(auxs) - set(aux_params))
    if extra or missing:
        raise MXNetError("params_from_jax: not in the symbol %s, aux states "
                         "missing %s" % (extra, missing))
    descs = _as_descs(data_shapes) or []
    a, _, x = symbol._infer(
        shape_kwargs={d.name: d.shape for d in descs},
        dtype_kwargs={d.name: d.dtype for d in descs}, partial=True)
    want = dict(zip(args, a))
    want.update(zip(auxs, x))
    result = []
    for values in (arg_params, aux_params):
        converted = {}
        for name, value in values.items():
            value = np.asarray(value)
            # numpy cannot hand torch a bfloat16 array: via float32, exact
            is_bf16 = value.dtype.name == "bfloat16"
            meta = want[name]
            got = (value.shape, "bfloat16" if is_bf16 else value.dtype.name)
            if meta is not None and got != (tuple(meta.shape),
                                            dtype_name(meta.dtype)):
                raise MXNetError(
                    "params_from_jax: %s is %s %s, the symbol binds it as "
                    "%s %s" % (name, got[1], got[0], dtype_name(meta.dtype),
                               tuple(meta.shape)))
            converted[name] = nd.array(
                value.astype(np.float32) if is_bf16 else value, ctx=ctx,
                dtype=got[1])
        result.append(converted)
    return result[0], result[1]
