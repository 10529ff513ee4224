"""Attribute scopes: ``with AttrScope(ctx_group="dev1"):`` attaches
attributes to the variables made inside.

Counterpart of ``mxnet_tpu/attribute.py:14-52`` (``AttrScope``,
``current``).  As in the JAX package, ``symbol.var`` is the one reader of
the scope (``mxnet_tpu/symbol/symbol.py:485``): op nodes take nothing
from it, so a ``ctx_group`` set by a scope lands on the variables only,
under the key ``ctx_group``.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]


class AttrScope:
    """Attributes (strings) for the variables made inside ``with``; a
    nested scope adds to, and overrides, the enclosing one's."""

    _current = threading.local()

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("Attributes need to be a string")
        self._attr = kwargs
        self._old_scope = None

    def get(self, attr):
        """The scope's attributes updated by ``attr`` (a dict or None)."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        self._old_scope = current()
        attr = self._old_scope._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, *exc):
        AttrScope._current.value = self._old_scope


def current():
    """The innermost scope (an empty one outside every ``with``)."""
    if not hasattr(AttrScope._current, "value"):
        AttrScope._current.value = AttrScope()
    return AttrScope._current.value
