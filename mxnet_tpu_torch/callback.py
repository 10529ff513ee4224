"""Training-loop callbacks: checkpointing, metric logging, throughput.

Counterpart of ``mxnet_tpu/callback.py`` (the reference's
``python/mxnet/callback.py``: checkpoint helpers at :27-90, Speedometer
at :120), host code.  ``Module.fit(epoch_end_callback=do_checkpoint(
prefix))`` writes a checkpoint each epoch, and ``Module.load`` with
``fit(begin_epoch=...)`` resumes from it.  ``do_checkpoint``'s
``async_write``, which queues the write on the JAX package's host-task
engine, raises here: the engine is not ported (ROADMAP A.11).
"""
from __future__ import annotations

import logging
import time

from .base import MXNetError

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar"]


def _metric_pairs(metric):
    """Flatten an EvalMetric into a list of (name, value) tuples, or []."""
    if metric is None:
        return []
    return list(metric.get_name_value())


def _fmt_pairs(pairs):
    return "".join("\t%s=%f" % nv for nv in pairs)


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Return an epoch-end callback that snapshots *mod* every *period* epochs.

    The callback signature matches the reference contract
    ``cb(epoch, symbol, arg_params, aux_params)``; only the epoch number is
    consulted — the module itself knows its parameters.
    """
    every = max(int(period), 1)

    def _on_epoch_end(epoch, sym=None, arg=None, aux=None):
        done = epoch + 1
        if done % every == 0:
            mod.save_checkpoint(prefix, done, save_optimizer_states)

    return _on_epoch_end


def do_checkpoint(prefix, period=1, async_write=False):
    """Return an epoch-end callback writing ``prefix-symbol.json`` +
    ``prefix-NNNN.params`` every *period* epochs (ref callback.py:56).
    ``async_write`` raises: it needs the host-task engine (ROADMAP
    A.11)."""
    from .model import save_checkpoint as _save
    if async_write:
        raise MXNetError("do_checkpoint(async_write=True) needs the "
                         "host-task engine, which is not ported yet "
                         "(ROADMAP A.11)")
    every = max(int(period), 1)

    def _on_epoch_end(epoch, sym, arg, aux):
        done = epoch + 1
        if done % every == 0:
            _save(prefix, done, sym, arg, aux)

    return _on_epoch_end


def log_train_metric(period, auto_reset=False):
    """Return a batch-end callback logging the running training metric
    every *period* batches (ref callback.py:84)."""

    def _on_batch_end(param):
        if param.nbatch % period != 0:
            return
        for name, value in _metric_pairs(param.eval_metric):
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset and param.eval_metric is not None:
            param.eval_metric.reset()

    return _on_batch_end


class Speedometer:
    """Batch-end callback printing samples/sec every ``frequent`` batches.

    Mirrors the reference Speedometer (callback.py:120): the first batch of an
    epoch only arms the timer; subsequent multiples of ``frequent`` report the
    rate over the window since the last report and (optionally) reset the
    metric so each report covers only its own window.
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._mark = None       # wall-clock at window start; None = disarmed
        self._prev_batch = -1

    def __call__(self, param):
        nbatch = param.nbatch
        if nbatch < self._prev_batch:   # new epoch rewound the counter
            self._mark = None
        self._prev_batch = nbatch

        if self._mark is None:
            self._mark = time.time()
            return
        if nbatch % self.frequent != 0:
            return

        elapsed = time.time() - self._mark
        rate = self.frequent * self.batch_size / max(elapsed, 1e-12)
        pairs = _metric_pairs(param.eval_metric)
        if pairs:
            if self.auto_reset:
                param.eval_metric.reset()
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                         param.epoch, nbatch, rate, _fmt_pairs(pairs))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, nbatch, rate)
        self._mark = time.time()


class ProgressBar:
    """Batch-end callback drawing an ASCII progress bar (ref callback.py:169)."""

    def __init__(self, total, length=80):
        self.total = max(int(total), 1)
        self.bar_len = int(length)

    def __call__(self, param):
        frac = min(param.nbatch / float(self.total), 1.0)
        ticks = int(self.bar_len * frac + 0.5)
        bar = "=" * ticks + "-" * (self.bar_len - ticks)
        logging.info("[%s] %d%%\r", bar, int(frac * 100 + 0.999))
