"""Automatic symbol naming (counterpart of ``mxnet_tpu/name.py``,
reference ``python/mxnet/name.py`` NameManager)."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "current"]


class NameManager:
    """Names unnamed symbols ``<hint><n>``, counting per hint."""
    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return "%s%d" % (hint, n)

    def __enter__(self):
        self._old_manager = current()
        NameManager._current.value = self
        return self

    def __exit__(self, *exc):
        NameManager._current.value = self._old_manager


def current():
    if not hasattr(NameManager._current, "value"):
        NameManager._current.value = NameManager()
    return NameManager._current.value
