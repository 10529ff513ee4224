"""``BaseModule``: the training and scoring loops.

Counterpart of ``mxnet_tpu/module/base_module.py`` (``BaseModule`` :74,
``_fit_step`` :95, ``fit`` :102, ``score`` :180, ``iter_predict`` :205,
``predict`` :217), written in terms of the primitives a subclass
implements (``bind``, ``forward``, ``backward``, ``update``, ...).
Checkpoint hooks, monitors and parameter files are not ported yet.
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from .. import ndarray as nd
from ..initializer import Uniform

__all__ = ["BaseModule", "BatchEndParam"]


class BatchEndParam:
    """What batch-end callbacks receive."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch, self.nbatch = epoch, nbatch
        self.eval_metric, self.locals = eval_metric, locals


def _fire(callbacks, *payload):
    if callbacks is None:
        return
    if not isinstance(callbacks, (list, tuple)):
        callbacks = (callbacks,)
    for cb in callbacks:
        cb(*payload)


def _coerce_metric(m):
    return m if isinstance(m, metric_mod.EvalMetric) else metric_mod.create(m)


def _check_input_names(symbol, names, typename):
    """Raise when a declared data/label name is not a symbol argument."""
    known = symbol.list_arguments()
    for name in names:
        if name not in known:
            suggestions = [a for a in known if not a.endswith(
                ("_weight", "_bias", "_gamma", "_beta"))]
            raise ValueError(
                "You created Module with Module(..., %s_names=%s) but input "
                "with name '%s' is not found in symbol.list_arguments(). Did "
                "you mean one of:\n\t%s" % (typename, names, name,
                                            "\n\t".join(suggestions)))


def _trim_pad(outputs, pad):
    """Drop the last ``pad`` rows (batch padding) of each output."""
    if not pad:
        return list(outputs)
    return [out[: out.shape[0] - pad] for out in outputs]


class BaseModule:
    """State flags and the generic loops over a subclass's primitives."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = self.params_initialized = False
        self.optimizer_initialized = False
        self.for_training = self.inputs_need_grad = False
        self._symbol = None

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def _fit_step(self, data_batch):
        """One step of the fit loop: forward, backward, update.  Module
        does all three in one call where it can."""
        self.forward_backward(data_batch)
        self.update()

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=None,
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None):
        """Train for ``num_epoch - begin_epoch`` epochs: bind,
        init_params, init_optimizer, then per epoch the training pass,
        the epoch callbacks and the validation score."""
        if num_epoch is None:
            raise ValueError("fit() requires num_epoch")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer or Uniform(0.01),
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        self.init_optimizer(
            kvstore=kvstore, optimizer=optimizer,
            optimizer_params=optimizer_params or (("learning_rate", 0.01),))
        train_metric = _coerce_metric(eval_metric)
        val_metric = validation_metric if validation_metric is not None \
            else train_metric
        for epoch in range(begin_epoch, num_epoch):
            started = time.time()
            train_metric.reset()
            for nbatch, batch in enumerate(train_data):
                self._fit_step(batch)
                self.update_metric(train_metric, batch.label)
                _fire(batch_end_callback,
                      BatchEndParam(epoch, nbatch, train_metric, locals()))
            for name, val in train_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - started)
            arg_now, aux_now = self.get_params()
            self.set_params(arg_now, aux_now)
            _fire(epoch_end_callback, epoch, self.symbol, arg_now, aux_now)
            if eval_data:
                for name, val in self.score(
                        eval_data, val_metric, epoch=epoch,
                        batch_end_callback=eval_batch_end_callback,
                        score_end_callback=eval_end_callback):
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """The metric over ``eval_data``, forward only."""
        self._require_ready()
        if reset:
            eval_data.reset()
        eval_metric = _coerce_metric(eval_metric)
        eval_metric.reset()
        seen = 0
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch >= num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            _fire(batch_end_callback,
                  BatchEndParam(epoch, nbatch, eval_metric, locals()))
            seen += 1
        _fire(score_end_callback,
              BatchEndParam(epoch, seen, eval_metric, locals()))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield (outputs without the batch padding, i, batch)."""
        self._require_ready()
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch >= num_batch:
                break
            self.forward(batch, is_train=False)
            yield _trim_pad(self.get_outputs(), batch.pad or 0), nbatch, batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over ``eval_data``, joined along the batch axis."""
        per_batch = [[o.copy() for o in outs] for outs, _, _
                     in self.iter_predict(eval_data, num_batch, reset)]
        if not per_batch or not merge_batches:
            return per_batch
        heads = len(per_batch[0])
        merged = [nd.concatenate([outs[i] for outs in per_batch])
                  for i in range(heads)]
        if heads == 1 and not always_output_list:
            return merged[0]
        return merged

    @property
    def symbol(self):
        return self._symbol

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def _require_ready(self):
        if not (self.binded and self.params_initialized):
            raise AssertionError("module must be binded and initialized")
