"""Named counters: how tests and ``chip_smoke.py`` prove call-count
claims.

Counterpart of ``mxnet_tpu/profiler.py:34`` (``bump``, ``counter``,
``counters`` and ``reset_counters``, re-exported there from
``telemetry/core.py:753-775``).  Counters are always on.  The names the
port bumps:

- ``program_calls``, the JAX package's ``xla_program_calls``: one per
  replay of a captured graph (``capture``), one per fused update run
  eagerly, one per parameter of the per-parameter update loop;
- ``graph_captures`` and ``graph_replays``: CUDA graphs captured and
  replayed by ``capture``;
- the hand-written kernels' launches: ``flash_attn_fwd_launches``,
  ``flash_attn_bwd_launches`` (``ops.attention``), ``scale_launches``
  (``ops.scale``), ``resize_rgb_chw_launches`` (``ops.image_nvjpeg``;
  the card's image loader launches it once a round of decodes, which
  ``nvjpeg_rounds`` counts) and ``nms_launches`` (``ops.nms``);
- ``create_graph_recomputes``: backwards of a captured hybridized
  block's call under ``create_graph``, each a recompute of the block's
  forward (``gluon.block._Replayed``);
- ``host_op_programs``: calls of a hybridized block or a Module step
  that ran eagerly on the card because their graph holds a ``Custom``
  op (``capture.graph_for``);
- the kvstore's, named as the JAX package names them (``kvstore``):
  ``kvstore_push``, ``kvstore_pull``, ``kvstore_bucket_reduce``,
  ``kvstore_reduce_scatter``, ``collective_chunk_programs`` and
  ``collective_gather_home``; a sum of several copies and a copy pulled
  also count in ``program_calls``.

A captured graph runs no Python when it replays, so ``capture`` records
what each counter moved while the graph was captured and adds that again
on every replay: a kernel's count is its launches on the device, whether
eager or replayed.
"""
from __future__ import annotations

import threading

__all__ = ["bump", "counter", "counters", "reset_counters"]

_lock = threading.Lock()
_counters = {}  # name -> int


def bump(name, n=1):
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name):
    """The counter ``name`` (0 if never bumped)."""
    return _counters.get(name, 0)


def counters():
    """A snapshot of every counter."""
    with _lock:
        return dict(_counters)


def reset_counters(*names):
    """Set the counters ``names`` to 0, or every counter when none is
    named."""
    with _lock:
        if not names:
            _counters.clear()
        for name in names:
            _counters.pop(name, None)


def _restore(snapshot, delta=None):
    """Set every counter to ``snapshot`` plus ``delta`` (both dicts)."""
    with _lock:
        _counters.clear()
        _counters.update(snapshot)
        for name, n in (delta or {}).items():
            _counters[name] = _counters.get(name, 0) + n


def _delta(before, after):
    """What each counter moved from ``before`` to ``after``."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}
