"""``Module``: a symbol bound on a context and trained with an optimizer.

Counterpart of ``mxnet_tpu/module/module.py:36`` (``bind`` :262 with
its ``shared_module`` :285-299, ``init_params`` :203,
``get_params``/``set_params`` :183/:240, ``output_shapes`` :132,
``init_optimizer`` :356, ``forward``/``backward``/``update``
:424-:538, ``_fit_step`` :453, ``_get_cached_step`` :474,
``get_input_grads`` :538, ``update_metric`` :549, ``prepare`` :557;
``state_names`` :66-79, kept among the parameters as there, with
``BaseModule.get_states``/``set_states``).
The module keeps host copies of the
parameters (NDArrays on ``cpu()``, as MXNet does) and the bound copies
on its context; ``update`` marks the host copies stale, and
``get_params`` brings them up to date.  ``_fit_step`` does forward,
backward and the update of every parameter in one call through
``cached_step.CachedTrainStep``, unless ``MXNET_MODULE_FUSED_STEP=0``
or the setup does not allow it; then it calls ``forward_backward`` and
``update``.  ``forward``, ``backward`` and ``forward_backward`` run the
executors' captured programs (``executor``).  The captured steps of
every input shape the module binds (its reshape cache), and its
executors' single-stage programs, share one graph-memory pool
(``capture.MemoryPool``); a ``BucketingModule`` hands its buckets one.
Bound with a ``shared_module``, the executor holds that module's
parameter, gradient and auxiliary NDArrays themselves.

Checkpoints (``load`` :84, ``save_checkpoint`` :94, the optimizer
states :105-120): ``prefix-symbol.json``, ``prefix-NNNN.params`` and
``prefix-NNNN.states`` in the formats both packages read
(``model.py``, ``Updater.get_states``).  ``Module.load(...,
load_optimizer_states=True)`` installs the states at
``init_optimizer``.

Several contexts (``init_optimizer`` :356, ``update`` :520-535): the
executor group binds one executor a context, each on its slice of the
batch (``work_load_list``), and ``init_optimizer`` picks the store and
where the update runs by ``model._create_kvstore``'s rules.  On the
store, ``update`` pushes the gradients and pulls the weights, and the
optimizer states are saved and loaded through it; else it sums the
gradients through the store (where there is one) and runs the local
updater on every context's copy.  ``_fit_step``'s one-call
``CachedTrainStep`` takes one executor and no store, so one context
with ``"local"`` or ``"device"`` keeps it.

:func:`params_from_jax` carries the JAX package's ``get_params()`` over
as numpy arrays.
"""
from __future__ import annotations

import logging
import os
import warnings
from collections import OrderedDict

import numpy as np

from ..base import MXNetError, dtype_name
from .. import capture
from .. import context as ctx_mod
from .. import ndarray as nd
from ..ndarray.sparse import from_reference
from .. import optimizer as opt
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint)
from ..stream import open_stream
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
    """A symbol with its data, label and parameter names, bound on a
    context or a list of them (default: the current context, ``gpu(0)``;
    with no card that raises), the batch split over them by
    ``work_load_list``."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        ctxs = context if context is not None \
            else ctx_mod.current_context()
        if isinstance(ctxs, ctx_mod.Context):
            ctxs = [ctxs]
        self._context = [ctx_mod.as_context(c) for c in ctxs]
        self._work_load_list = list(work_load_list
                                    or [1] * len(self._context))
        if len(self._work_load_list) != len(self._context):
            raise ValueError("work_load_list must have one entry per "
                             "context")
        self._symbol = symbol
        args = symbol.list_arguments()
        self._data_names = list(data_names or [])
        self._label_names = [n for n in (label_names or []) if n in args]
        inputs = set(self._data_names) | set(label_names or [])
        self._param_names = [a for a in args if a not in inputs]
        self._fixed_param_names = list(fixed_param_names or [])
        # filed among the parameters, as the JAX package does (:66-79)
        self._state_names = list(state_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        _check_input_names(symbol, self._data_names, "data")
        self._arg_params = self._aux_params = None
        self._params_dirty = False
        self._optimizer = self._updater = self._kvstore = None
        self._update_on_kvstore = False
        self._preload_opt_states = None
        self._cached_step, self._cached_step_unusable = None, False
        self._exec_group = self._data_shapes = self._label_shapes = None
        self._shares_device_params = False
        self._graph_pool = capture.MemoryPool()

    # -- checkpoints -----------------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module from ``prefix-symbol.json`` and ``prefix-%04d.params``
        (``kwargs`` go to the constructor); bind it and call
        ``init_optimizer``, which installs ``prefix-%04d.states`` where
        ``load_optimizer_states``."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Write the symbol, the parameters and, where asked, the optimizer
        states of ``epoch``."""
        self._symbol.save(prefix + "-symbol.json")
        params_file = "%s-%04d.params" % (prefix, epoch)
        self.save_params(params_file)
        logging.info('Saved checkpoint to "%s"', params_file)
        if save_optimizer_states:
            states_file = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(states_file)
            logging.info('Saved optimizer state to "%s"', states_file)

    def save_optimizer_states(self, fname):
        """Write the optimizer states (the store's where the update runs
        there)."""
        if not self.optimizer_initialized:
            raise AssertionError("optimizer not initialized")
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        with open_stream(fname, "wb") as fh:
            fh.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Install the states of ``fname`` (into the store where the update
        runs there); a captured step that held the old ones captures again
        at its next step."""
        if not self.optimizer_initialized:
            raise AssertionError("optimizer not initialized")
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open_stream(fname, "rb") as fh:
            self._updater.set_states(fh.read())

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

    @property
    def output_shapes(self):
        """(name, shape) of each output at the bound input shapes and
        dtypes (a graph whose parameters are fp64 infers in fp64)."""
        self._require_bound()
        descs = self._data_shapes + (self._label_shapes or [])
        _, outs, _ = self._symbol._infer(
            shape_kwargs={d.name: d.shape for d in descs},
            dtype_kwargs={d.name: d.dtype for d in descs
                          if d.dtype is not None})
        return [(n, tuple(o.shape)) for n, o in zip(self._output_names,
                                                     outs)]

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

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        """Set the parameters; with ``allow_missing`` only the names given
        are written, straight into the bound arrays."""
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=False,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            warnings.warn("set_params ignored: already initialized "
                          "(pass force_init=True to override)", stacklevel=2)
            return
        self._exec_group.set_params(arg_params, aux_params,
                                    allow_extra=allow_extra)
        self._params_dirty, self.params_initialized = True, True

    # -- binding -------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind an executor for these input shapes (and dtypes, from each
        ``DataDesc``).  With a bound ``shared_module`` the executor holds
        that module's parameter, gradient and auxiliary NDArrays (a
        ``BucketingModule``'s buckets share the leader's), and this module
        takes its host parameters."""
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
        donor = getattr(shared_module, "_exec_group", None)
        self._exec_group = self._make_exec_group(donor)
        self._reshape_cache = OrderedDict({self._shape_key():
                                           self._exec_group})
        self.binded = True
        self._shares_device_params = donor is not None \
            and self._exec_group.shares_params
        if shared_module is not None:
            if not self._shares_device_params \
                    and shared_module._params_dirty:
                shared_module.get_params()
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self.params_initialized = shared_module.params_initialized
            self._params_dirty = shared_module._params_dirty
        if self.params_initialized and not self._shares_device_params:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def _make_exec_group(self, shared_group=None):
        self._cached_step = None
        group = DataParallelExecutorGroup(
            self._symbol, self._context, self._data_shapes,
            self._label_shapes, self._param_names, self.for_training,
            self.inputs_need_grad, fixed_param_names=self._fixed_param_names,
            grad_req=self._grad_req, shared_group=shared_group,
            workload=self._work_load_list, state_names=self._state_names)
        for ex in group.execs:
            ex.graph_pool = self._graph_pool
        return group

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
        """Make the store (``kvstore``: None, a name or a ``KVStore``; see
        ``model._create_kvstore``), the optimizer (``rescale_grad``
        defaults to 1 / batch) and its Updater, on the store where the
        update runs there."""
        self._require_ready()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self.get_params()
        group = self._exec_group
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        if isinstance(optimizer, str):
            n = group.num_device
            idx2name = {}
            for i, name in enumerate(group.param_names):
                if update_on_kvstore:
                    idx2name[i] = name
                else:
                    idx2name.update((i * n + k, name) for k in range(n))
            kwargs = dict(optimizer_params)
            kwargs.setdefault("rescale_grad", 1.0 / group.batch_size)
            optimizer = opt.create(optimizer, sym=self._symbol,
                                   param_idx2name=idx2name, **kwargs)
        elif not isinstance(optimizer, opt.Optimizer):
            raise TypeError("optimizer must be a name or an Optimizer")
        self._optimizer, self._kvstore = optimizer, kvstore
        self._update_on_kvstore = update_on_kvstore
        if kvstore:
            _initialize_kvstore(kvstore, group.param_arrays, self._arg_params,
                                self._param_names, update_on_kvstore)
        if update_on_kvstore:
            self._updater = None
            kvstore.set_optimizer(optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        self._cached_step, self._cached_step_unusable = None, False
        self.optimizer_initialized = True
        if self._preload_opt_states:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

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
        """One optimizer update of every parameter that has a gradient: on
        the store (push the gradients, pull the weights), or with the
        local updater on every context's copy after the store's sum."""
        if not self.optimizer_initialized:
            raise AssertionError("init_optimizer must run before update")
        self._require_ready()
        self._params_dirty = True
        group = self._exec_group
        if self._update_on_kvstore:
            _update_params_on_kvstore(group.param_arrays, group.grad_arrays,
                                      self._kvstore, group.param_names)
        else:
            _update_params(group.param_arrays, group.grad_arrays,
                           self._updater, group.num_device, self._kvstore,
                           group.param_names)

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
        """The one-call step, or None where the two-call path runs: a
        store, several contexts, inputs that take gradients, an installed
        monitor or an optimizer without a fused update (reference
        ``:474-490``).  A CSR
        argument is a static input of the step's program, in buffers of a
        fixed capacity (``ndarray.sparse``)."""
        if self._cached_step_unusable or not fused_step_enabled() \
                or not self.optimizer_initialized or self.inputs_need_grad \
                or self._updater is None or self._kvstore is not None \
                or len(self._exec_group.execs) != 1:
            return None
        ex = self._exec_group.execs[0]
        if ex._monitor is not None:   # reference ``:486``
            return None
        if any(r not in ("write", "null") for r in ex.grad_req.values()):
            return None
        step = self._cached_step
        if step is not None and step._exec is ex \
                and step._updater is self._updater:
            return step
        try:
            self._cached_step = CachedTrainStep(
                ex, self._updater, self._exec_group.param_names,
                pool=self._graph_pool)
        except ValueError:
            self._cached_step, self._cached_step_unusable = None, True
        self._exec_group.cached_step = self._cached_step
        return self._cached_step

    def get_outputs(self, merge_multi_context=True):
        self._require_ready()
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require_ready()
        if not self.inputs_need_grad:
            raise AssertionError("bind with inputs_need_grad=True first")
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """Tap every executor's outputs with ``mon`` (a :class:`Monitor`
        or a callback); from here on the one-call step is not taken."""
        if not self.binded:
            raise AssertionError("module must be binded first")
        self._exec_group.install_monitor(mon)


def params_from_jax(arg_params, aux_params, symbol, ctx=None,
                    data_shapes=None):
    """The JAX package's ``Module.get_params()`` dicts, given as numpy
    arrays (``{n: v.asnumpy()}``; bfloat16 as ``ml_dtypes.bfloat16``),
    as NDArrays on ``ctx`` (default: the current context) for
    ``Module.set_params``.  A value may also be the JAX package's NDArray
    itself: its storage tag is kept, and a CSR keeps its parts
    (``ndarray.sparse.from_reference``).

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
            if hasattr(value, "asnumpy"):   # the JAX package's NDArray
                arr = from_reference(value, ctx)
                got = (tuple(arr.shape), dtype_name(arr.dtype))
            else:
                value = np.asarray(value)
                # numpy cannot hand torch a bfloat16 array: via float32,
                # exact
                is_bf16 = value.dtype.name == "bfloat16"
                got = (value.shape, "bfloat16" if is_bf16
                       else value.dtype.name)
                arr = nd.array(value.astype(np.float32) if is_bf16
                               else value, ctx=ctx, dtype=got[1])
            meta = want[name]
            if meta is not None and got != (tuple(meta.shape),
                                            dtype_name(meta.dtype)):
                raise MXNetError(
                    "params_from_jax: %s is %s %s, the symbol binds it as "
                    "%s %s" % (name, got[1], got[0], dtype_name(meta.dtype),
                               tuple(meta.shape)))
            converted[name] = arr
        result.append(converted)
    return result[0], result[1]
