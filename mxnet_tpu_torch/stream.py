"""Pluggable stream opener: URI-scheme dispatch for save and load.

Counterpart of ``mxnet_tpu/stream.py``, which stands in for dmlc-core's
streams (every reference save/load path takes ``s3://`` or ``hdfs://``
URIs, ``include/mxnet/ndarray.h:340``; ``dmlc/io.h`` Stream::Create
dispatches on the scheme).  A registry of Python openers takes the place
of the C++ stream classes: a URI with a scheme prefix goes to its
registered opener (an fsspec-style callable), a bare path to ``open``.

Usage::

    import mxnet_tpu_torch as mt

    def s3_opener(uri, mode):
        import s3fs                       # any fsspec filesystem
        return s3fs.S3FileSystem().open(uri, mode)

    mt.stream.register_scheme("s3", s3_opener)
    mt.nd.save("s3://bucket/model.params", {"w": w})

The built-in schemes are ``file`` and ``mem``, an in-process store for
tests and ephemeral checkpoints.  The ``mem://`` store is this package's
own: the JAX package keeps a separate one, and bytes pass between them
through ``nd.save_to_bytes``/``nd.load_from_bytes``.
"""
from __future__ import annotations

import io
import os
import re
import threading

from .base import MXNetError

__all__ = ["register_scheme", "unregister_scheme", "open_stream",
           "registered_schemes", "split_scheme"]

_SCHEME_RE = re.compile(r"^([A-Za-z][A-Za-z0-9+.-]*)://")

_REGISTRY = {}
_LOCK = threading.Lock()


def split_scheme(uri):
    """('s3', 'bucket/key') for 's3://bucket/key'; (None, uri) for bare
    paths. Windows drive letters ('C:/x') have no '//' so they stay
    bare paths."""
    if not isinstance(uri, (str, os.PathLike)):
        return None, uri
    s = os.fspath(uri)
    m = _SCHEME_RE.match(s)
    if not m:
        return None, s
    return m.group(1).lower(), s[m.end():]


def register_scheme(scheme, opener):
    """Install ``opener(uri, mode) -> file-like`` for ``scheme://`` URIs.

    The opener receives the FULL uri (scheme included, the fsspec
    convention) and a binary/text mode string. Re-registering a scheme
    replaces the previous opener (returned, for restore-style tests)."""
    if not re.match(r"^[A-Za-z][A-Za-z0-9+.-]*$", scheme or ""):
        raise MXNetError("invalid scheme %r" % (scheme,))
    with _LOCK:
        prev = _REGISTRY.get(scheme.lower())
        _REGISTRY[scheme.lower()] = opener
    return prev


def unregister_scheme(scheme):
    with _LOCK:
        return _REGISTRY.pop(scheme.lower(), None)


def registered_schemes():
    with _LOCK:
        return sorted(_REGISTRY)


def open_stream(uri, mode="rb"):
    """Open *uri* for reading/writing. Scheme-prefixed URIs dispatch to
    their registered opener; bare paths use the local filesystem."""
    scheme, _rest = split_scheme(uri)
    if scheme is None or scheme == "file":
        path = _rest if scheme == "file" else os.fspath(uri)
        return open(path, mode)
    with _LOCK:
        opener = _REGISTRY.get(scheme)
    if opener is None:
        raise MXNetError(
            "no stream opener registered for scheme %r (uri %r); "
            "register one with mxnet_tpu_torch.stream.register_scheme"
            % (scheme, uri))
    return opener(os.fspath(uri), mode)


# ---------------------------------------------------------------------------
# mem:// — in-process store (tests, ephemeral checkpoints)
# ---------------------------------------------------------------------------

_MEM = {}
_MEM_LOCK = threading.Lock()


class _MemWriter(io.BytesIO):
    def __init__(self, key):
        super().__init__()
        self._key = key

    def close(self):
        with _MEM_LOCK:
            _MEM[self._key] = self.getvalue()
        super().close()


def _mem_opener(uri, mode):
    _, key = split_scheme(uri)
    if "w" in mode:
        writer = _MemWriter(key)
        return writer if "b" in mode else io.TextIOWrapper(writer)
    with _MEM_LOCK:
        if key not in _MEM:
            raise FileNotFoundError(uri)
        raw = io.BytesIO(_MEM[key])
    return raw if "b" in mode else io.TextIOWrapper(raw)


register_scheme("mem", _mem_opener)
