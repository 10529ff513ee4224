"""``BucketingModule``: one ``Module`` per bucket key (a sequence
length), all over the same parameters.

Counterpart of ``mxnet_tpu/module/bucketing_module.py``.  The default
bucket's module is the leader: it owns the host parameters and the
optimizer, which each bucket borrows (``switch_bucket`` :173, the
lending :220).  Each bucket binds with ``shared_module=leader``, so its
executor holds the leader's parameter, gradient and auxiliary NDArrays
themselves: an update through any bucket is the update of every bucket,
and a switch copies nothing (the JAX package copies its buckets' arrays
back to the leader after each step, ``_sync_active_to_leader`` :247; a
bucket whose parameters cannot be shared, because its graph gives them
other shapes, still does).  ``_fit_step`` runs the bucket's own
``CachedTrainStep``; on the card the captured steps of every bucket
share one graph-memory pool (``capture.MemoryPool``), and the leader's
step, the largest bucket by the iterator's convention, is captured
first, so that the pool is sized by it.  A switch drops the outputs of
the bucket left: as in MXNet, whose buckets share one memory pool, only
the active bucket's outputs are valid.
"""
from __future__ import annotations

import logging
import warnings

from .. import capture
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """Routes each batch to the Module bound for its ``bucket_key``."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise ValueError("default_bucket_key is required")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._module_kwargs = dict(logger=logger, context=context,
                                   work_load_list=work_load_list,
                                   fixed_param_names=fixed_param_names,
                                   state_names=state_names)
        self._by_key = {}
        self._active_key = None
        self._params_dirty = False
        self._graph_pool = capture.MemoryPool()
        self._leader_captured = False

    # -- internals ------------------------------------------------------------
    @property
    def _active(self):
        return self._by_key.get(self._active_key)

    @property
    def _leader(self):
        return self._by_key.get(self._default_bucket_key)

    def _spawn(self, bucket_key, data_shapes, label_shapes, shared):
        """Make and bind the Module of ``bucket_key``."""
        sym, data_names, label_names = self._sym_gen(bucket_key)
        mod = Module(sym, data_names, label_names, **self._module_kwargs)
        mod._graph_pool = self._graph_pool
        mod.bind(data_shapes, label_shapes, for_training=self.for_training,
                 inputs_need_grad=self.inputs_need_grad,
                 shared_module=shared, grad_req=self._grad_req)
        self._by_key[bucket_key] = mod
        return mod

    # -- properties (the active module's) -------------------------------------
    @property
    def data_names(self):
        if self.binded:
            return self._active.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._active.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        self._require_bound()
        return self._active.data_shapes

    @property
    def label_shapes(self):
        self._require_bound()
        return self._active.label_shapes

    @property
    def output_shapes(self):
        self._require_bound()
        return self._active.output_shapes

    @property
    def symbol(self):
        self._require_bound()
        return self._active.symbol

    def _require_bound(self):
        if not self.binded:
            raise AssertionError("BucketingModule is not bound")

    # -- parameters -----------------------------------------------------------
    def get_params(self):
        self._require_ready()
        self._active._params_dirty = self._params_dirty
        out = self._active.get_params()
        self._params_dirty = False
        return out

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        self._require_bound()
        self._active.init_params(initializer=initializer,
                                 arg_params=arg_params, aux_params=aux_params,
                                 allow_missing=allow_missing,
                                 force_init=force_init,
                                 allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=False,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            warnings.warn("set_params ignored: already initialized "
                          "(pass force_init=True to override)", stacklevel=2)
            return
        self._active.set_params(arg_params, aux_params, allow_missing=True,
                                force_init=force_init,
                                allow_extra=allow_extra)
        self._params_dirty, self.params_initialized = True, True

    def get_states(self, merge_multi_context=True):
        self._require_ready()
        return self._active.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        self._require_ready()
        self._active.set_states(states, value)

    # -- binding and switching ------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if shared_module is not None:
            raise ValueError("BucketingModule does not accept shared_module")
        if force_rebind:
            self.binded = False
            self._by_key, self._active_key = {}, None
            self._graph_pool = capture.MemoryPool()
            self._leader_captured = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self.binded = True
        self._spawn(self._default_bucket_key, data_shapes, label_shapes,
                    shared=None)
        self._active_key = self._default_bucket_key

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` active, binding its module against the
        leader's arrays on first use."""
        self._require_bound()
        left = self._active
        if bucket_key not in self._by_key:
            self._spawn(bucket_key, data_shapes, label_shapes,
                        shared=self._leader)
        self._active_key = bucket_key
        mod = self._active
        if left is not mod:
            for ex in left._exec_group.execs:
                ex._outputs = None
        if self.params_initialized and mod is not self._leader:
            leader = self._leader
            mod._arg_params, mod._aux_params = (leader._arg_params,
                                                leader._aux_params)
            mod.params_initialized = True
            if mod._shares_device_params:
                mod._params_dirty = self._params_dirty
            else:
                if leader._params_dirty:
                    leader.get_params()
                mod._exec_group.set_params(leader._arg_params,
                                           leader._aux_params)
        if self.optimizer_initialized and not mod.optimizer_initialized:
            self._lend_optimizer(mod)

    # -- optimizer ------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._require_ready()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        owner = self._active
        owner.init_optimizer(kvstore, optimizer, optimizer_params,
                             force_init=force_init)
        for mod in self._by_key.values():
            if mod is not owner:
                self._lend_optimizer(mod, owner)
        self.optimizer_initialized = True

    def _lend_optimizer(self, mod, owner=None):
        """Point ``mod`` at the optimizer, updater and store of ``owner``
        (the leader's by default)."""
        owner = owner or self._leader
        mod._optimizer, mod._updater = owner._optimizer, owner._updater
        mod._kvstore = owner._kvstore
        mod._update_on_kvstore = owner._update_on_kvstore
        mod._cached_step, mod._cached_step_unusable = None, False
        mod.optimizer_initialized = True

    # -- computation ----------------------------------------------------------
    def prepare(self, data_batch):
        self._require_ready()
        self._switch_for_batch(data_batch)

    def _switch_for_batch(self, data_batch):
        key = getattr(data_batch, "bucket_key", None)
        if key is not None and key != self._active_key:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)

    def forward(self, data_batch, is_train=None):
        self._require_ready()
        self._switch_for_batch(data_batch)
        self._active.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._require_ready()
        self._active.backward(out_grads=out_grads)

    def _capture_leader_first(self):
        """Capture the leader's step before any other bucket's, so that the
        shared pool is sized by the largest program."""
        if self._leader_captured or self._active is self._leader:
            self._leader_captured = True
            return
        step = self._leader._get_cached_step()
        if step is not None:
            step.capture()
        self._leader_captured = True

    def _fit_step(self, data_batch):
        """Switch to the batch's bucket and take its one-call step."""
        self._require_ready()
        self._switch_for_batch(data_batch)
        self._capture_leader_first()
        self._params_dirty = True
        self._active._fit_step(data_batch)
        self._after_update()

    def update(self):
        self._require_ready()
        if not self.optimizer_initialized:
            raise AssertionError("init_optimizer must run before update")
        self._params_dirty = True
        self._active.update()
        self._after_update()

    def _after_update(self):
        """The leader's host parameters are stale now; a bucket that does
        not share the leader's arrays hands its own back."""
        leader, mod = self._leader, self._active
        leader._params_dirty = True
        if mod is leader or mod._shares_device_params:
            return
        arg, aux = mod.get_params()
        leader._arg_params, leader._aux_params = arg, aux
        leader._exec_group.set_params(arg, aux)
        leader._params_dirty = False

    def get_outputs(self, merge_multi_context=True):
        self._require_ready()
        return self._active.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require_ready()
        if not self.inputs_need_grad:
            raise AssertionError("bind with inputs_need_grad=True first")
        return self._active.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._require_ready()
        self._active.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """``mon`` on every bucket's Module (reference ``:298``); a
        bucket made later does not get it, as in the reference."""
        self._require_bound()
        for mod in self._by_key.values():
            mod.install_monitor(mon)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """The leader's checkpoint: the default bucket's symbol and the
        shared parameters (and optimizer states)."""
        self._leader.save_checkpoint(prefix, epoch, save_optimizer_states)
