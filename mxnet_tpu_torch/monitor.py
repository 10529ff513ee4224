"""``Monitor``: statistics of a bound graph's outputs every ``interval``
batches.

Counterpart of ``mxnet_tpu/monitor.py:63-147`` in its eager mode.  An
armed monitor (:meth:`Monitor.tic` on a batch of the interval) makes
the executors it is installed on run that batch's forward node by node,
eagerly (``Executor._graph``), and see every op output by name; the
batches between take the captured programs, and a ``Module`` with a
monitor installed never takes its one-call step (``Module.
_get_cached_step``).  The default statistic is ``mean(|x|)``, computed on
the output's device; :meth:`Monitor.toc` reads the statistics back as
strings.

The JAX package's compiled mode (``MXNET_MODEL_STATS`` set) reads the
statistics that its fused trainer writes (``mxnet_tpu/model_stats.py``),
which the port does not have yet (ROADMAP A.10): with the variable set,
a Monitor raises :class:`MXNetError`.
"""
from __future__ import annotations

import os
import re

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["Monitor"]

_OFF = ("", "0", "false", "off", "no")


def _compiled_mode_asked():
    """Whether ``MXNET_MODEL_STATS`` asks for the compiled mode, as the
    JAX package parses it (``mxnet_tpu/model_stats.py:59-76``)."""
    raw = os.environ.get("MXNET_MODEL_STATS")
    if raw is None or raw.strip().lower() in _OFF:
        return False
    raw = raw.strip().lower()
    if raw in ("1", "true", "on", "yes"):
        return True
    try:
        return int(raw) > 0
    except ValueError:
        return False


def _default_stat(x):
    """mean(|x|)."""
    return x.abs().mean() if hasattr(x, "abs") else x


def _render(value):
    """A statistic (an NDArray, or a list of them) as tab-joined text:
    a scalar as its number, an array as numpy prints it."""
    items = value if isinstance(value, list) else [value]
    parts = []
    for v in items:
        if not isinstance(v, NDArray):
            raise MXNetError("the argument must be NDArray")
        if v.shape in ((), (1,)):
            parts.append(str(v.asnumpy().reshape(-1)[0]))
        else:
            parts.append(str(v.asnumpy()))
    return "\t".join(parts) + "\t"


class Monitor:
    """Collect ``stat_func`` of every output whose name matches
    ``pattern`` on each ``interval``-th batch; ``sort`` orders
    :meth:`toc`'s rows by name."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if _compiled_mode_asked():
            raise MXNetError(
                "Monitor: MXNET_MODEL_STATS asks for the compiled mode, whose "
                "statistics come from model_stats, not yet ported (ROADMAP "
                "A.10); unset it to monitor outputs eagerly")
        self.interval, self.sort = interval, sort
        self.stat_func = stat_func or _default_stat
        self.re_prog = re.compile(pattern)
        self.activated, self.queue = False, []
        self.step, self.exes = 0, []

        mon = self

        def stat_helper(name, arr):
            if mon.activated and mon.re_prog.match(name):
                mon.queue.append((mon.step, name, mon.stat_func(arr)))
        # the Executor asks at each forward whether to run node by node
        stat_helper.is_active = lambda: mon.activated
        self.stat_helper = stat_helper

    def install(self, exe):
        """Tap the outputs of an Executor."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Start a batch: arm collection if the batch is on the interval
        (call before the forward)."""
        due = self.step % self.interval == 0
        self.step += 1
        if due:
            self.queue, self.activated = [], True

    def toc(self):
        """End a batch: disarm, and return its rows [(step, name,
        statistic as text)] (none when the batch was not armed)."""
        was_armed, self.activated = self.activated, False
        if not was_armed:
            return []
        rows = [(step, name, _render(val)) for step, name, val in self.queue]
        self.queue = []
        if self.sort:
            rows.sort(key=lambda row: row[1])
        return rows

    def toc_print(self):
        """:meth:`toc`, each row printed."""
        rows = self.toc()
        for step, name, stat in rows:
            print("Batch: {:7d} {:30s} {:s}".format(step, name, stat))
        return rows
