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
and update each context's copy with the local updater.  The legacy
``FeedForward`` is ROADMAP A.5.
"""
from __future__ import annotations

import logging

import numpy as np

from .base import MXNetError
from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym

__all__ = ["save_checkpoint", "load_checkpoint", "split_saved_params",
           "_create_kvstore", "_initialize_kvstore",
           "_update_params_on_kvstore", "_update_params"]

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
