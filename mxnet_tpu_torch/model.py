"""Checkpoint files, and the kvstore's part in a training step.

Counterpart of ``mxnet_tpu/model.py:35-135``.  Checkpoints
(``save_checkpoint``, ``split_saved_params``, ``load_checkpoint``; the
format of SURVEY.md §5.4): the parameters go into one ``nd.save`` dict,
named ``arg:<name>`` and ``aux:<name>``.  The kvstore helpers that
``Module`` uses (``_create_kvstore`` :35, ``_initialize_kvstore``,
``_update_params_on_kvstore``, ``_update_params``): which store a
training run takes and whether the optimizer runs on it, the store's
keys (the parameter names), and the two ways of one update -- push the
gradients and pull the updated weights, or push and pull the gradients
and update each context's copy with the local updater.
``BatchEndParam`` (``:27``) is what batch-end callbacks receive.  The
legacy ``FeedForward`` (``:125-248``) trains, predicts, scores, saves
and loads through a ``Module``, as the JAX package's does; its ``ctx``
defaults to the current context (the card), and, as there, ``fit``
accepts ``monitor``, ``logger`` and ``work_load_list`` and passes none
of them on.
"""
from __future__ import annotations

import logging

import numpy as np

from .base import MXNetError
from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym
from .context import current_context

__all__ = ["save_checkpoint", "load_checkpoint", "split_saved_params",
           "_create_kvstore", "_initialize_kvstore",
           "_update_params_on_kvstore", "_update_params", "FeedForward",
           "BatchEndParam"]


class BatchEndParam:
    """What batch-end callbacks receive."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch, self.nbatch = epoch, nbatch
        self.eval_metric, self.locals = eval_metric, locals

# a "local" store updates on the workers once a parameter is larger
_UPDATE_ON_KVSTORE_MAX_ELEMS = 1024 * 1024 * 16


def _create_kvstore(kvstore, num_device, arg_params):
    """(store, update_on_kvstore) for a ``kvstore`` spec: None, a name or
    a :class:`~kvstore.KVStore`.  One context with a name that is not
    distributed takes no store; ``"local"`` updates on the store unless
    its largest parameter exceeds 16M elements; an instance always
    updates on the store."""
    if kvstore is None or isinstance(kvstore, kvs.KVStore):
        return kvstore, kvstore is not None
    if not isinstance(kvstore, str):
        raise TypeError("kvstore must be KVStore, str or None")
    if num_device == 1 and "dist" not in kvstore:
        return None, False
    kv = kvs.create(kvstore)
    update_on_kvstore = True
    if kvstore == "local":
        biggest = max(int(np.prod(p.shape)) for p in arg_params.values())
        update_on_kvstore = biggest <= _UPDATE_ON_KVSTORE_MAX_ELEMS
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Give the store each parameter under its name; when the update runs
    on the store, pull the values into every context's copy."""
    for slot, (name, devs) in enumerate(zip(param_names, param_arrays)):
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, devs, priority=-slot)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """The update on the store: push each parameter's gradients, pull the
    updated weight into every context's copy."""
    for slot, (weights, grads) in enumerate(zip(param_arrays, grad_arrays)):
        if grads is None or grads[0] is None:
            continue
        kvstore.push(param_names[slot], grads, priority=-slot)
        kvstore.pull(param_names[slot], weights, priority=-slot)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """The update on the workers: sum each parameter's gradients through
    the store where there is one, then update every context's copy with
    ``updater``, slot ``slot * num_device + device``."""
    for slot, (weights, grads) in enumerate(zip(param_arrays, grad_arrays)):
        if grads is None or grads[0] is None:
            continue
        if kvstore:
            kvstore.push(param_names[slot], grads, priority=-slot)
            kvstore.pull(param_names[slot], grads, priority=-slot)
        for dev, (w, g) in enumerate(zip(weights, grads)):
            updater(slot * num_device + dev, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` (unless ``symbol`` is None) and
    ``prefix-%04d.params`` % epoch."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    blob = {}
    for tag, group in (("arg:", arg_params), ("aux:", aux_params)):
        for name, arr in group.items():
            blob[tag + name] = arr
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, blob)
    logging.info('Saved checkpoint to "%s"', param_name)


def split_saved_params(loaded):
    """A loaded ``.params`` dict split into (arg_params, aux_params) by the
    ``arg:``/``aux:`` key prefixes; keys with neither are dropped."""
    if not isinstance(loaded, dict):
        raise MXNetError(
            "params file contains unnamed arrays; expected the "
            "arg:/aux:-keyed dict written by save_checkpoint")
    arg_params, aux_params = {}, {}
    groups = {"arg": arg_params, "aux": aux_params}
    for key, val in loaded.items():
        kind, _, name = key.partition(":")
        if kind in groups:
            groups[kind][name] = val
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) of a checkpoint that
    :func:`save_checkpoint` wrote, the arrays on ``cpu(0)``."""
    symbol = sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = split_saved_params(
        nd.load("%s-%04d.params" % (prefix, epoch)))
    return symbol, arg_params, aux_params


class FeedForward:
    """The legacy training API over :class:`~mxnet_tpu_torch.module.Module`:
    ``fit`` on arrays (batches of ``numpy_batch_size``, shuffled) or a
    ``DataIter``, then ``predict``/``score``, ``save``/``load``."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .initializer import Uniform
        self.symbol = symbol
        self.ctx = list(ctx) if isinstance(ctx, (list, tuple)) \
            else [ctx or current_context()]
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs
        self._module = None

    def _get_module(self, data_iter):
        """A Module of the symbol, its data and label names from
        ``data_iter`` (label arguments named ``*_label`` where the
        iterator has no labels: they stay inputs, not parameters)."""
        from .module import Module
        label_names = [d.name if hasattr(d, "name") else d[0]
                       for d in (data_iter.provide_label or [])]
        if not label_names:
            label_names = [n for n in self.symbol.list_arguments()
                           if n.endswith("_label")]
        data_names = [d.name if hasattr(d, "name") else d[0]
                      for d in data_iter.provide_data]
        return Module(self.symbol, data_names=data_names,
                      label_names=label_names, context=self.ctx)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            **kwargs):
        """Train ``num_epoch`` epochs (1 when not given) from
        ``begin_epoch``; the parameters are kept in ``arg_params`` and
        ``aux_params``."""
        train_data = self._prepare_data(X, y)
        mod = self._get_module(train_data)
        mod.fit(train_data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=dict(self.kwargs),
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch or 1)
        self._module = mod
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def _prepare_data(self, X, y=None):
        from .io import NDArrayIter, DataIter
        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                           shuffle=True)

    def _ensure_module(self, data_iter):
        """The fitted Module, or one bound for prediction from the loaded
        parameters (initialized where there are none)."""
        if self._module is not None and self._module.binded:
            return self._module
        mod = self._get_module(data_iter)
        mod.bind(data_shapes=data_iter.provide_data,
                 label_shapes=data_iter.provide_label or None,
                 for_training=False)
        if self.arg_params is not None:
            mod.set_params(self.arg_params, self.aux_params or {},
                           allow_missing=False)
        else:
            mod.init_params(initializer=self.initializer)
            self.arg_params, self.aux_params = mod.get_params()
        self._module = mod
        return mod

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over ``X``, as numpy."""
        data = self._prepare_data(X)
        outs = self._ensure_module(data).predict(data, num_batch=num_batch)
        return outs.asnumpy() if hasattr(outs, "asnumpy") else outs

    def score(self, X, eval_metric="acc", num_batch=None, **kwargs):
        """The value of ``eval_metric`` over ``X``."""
        data = self._prepare_data(X)
        res = self._ensure_module(data).score(data, eval_metric,
                                              num_batch=num_batch)
        return res[0][1]

    def save(self, prefix, epoch=None):
        """A checkpoint (:func:`save_checkpoint`) at ``epoch`` (default
        ``num_epoch``, or 0)."""
        if epoch is None:
            epoch = self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params,
                        self.aux_params)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """A FeedForward from a checkpoint, to continue from ``epoch``."""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, **kwargs):
        """A FeedForward made and fitted in one call."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list)
        return model
