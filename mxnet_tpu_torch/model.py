"""Checkpoint files: ``prefix-symbol.json`` and ``prefix-NNNN.params``.

Counterpart of ``mxnet_tpu/model.py:91-135`` (``save_checkpoint``,
``split_saved_params``, ``load_checkpoint``; the format of SURVEY.md
§5.4): the parameters go into one ``nd.save`` dict, named ``arg:<name>``
and ``aux:<name>``.  The legacy ``FeedForward`` waits for the data
path (ROADMAP A.5).
"""
from __future__ import annotations

import logging

from .base import MXNetError
from . import ndarray as nd
from . import symbol as sym

__all__ = ["save_checkpoint", "load_checkpoint", "split_saved_params"]


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
