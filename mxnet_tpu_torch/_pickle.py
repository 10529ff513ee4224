"""Optimizer-state pickles that both packages read.

``Updater.get_states`` and ``Trainer.save_states`` write pickles, as the
JAX package does (``mxnet_tpu/optimizer.py:706-722``,
``mxnet_tpu/gluon/trainer.py:265-310``).  There an NDArray pickles as
``mxnet_tpu.ndarray.ndarray._nd_unpickle(npy, dev_type, dev_id, stype)``
(``mxnet_tpu/ndarray/ndarray.py:149``, ``:462``), its numpy array
through numpy's own reduction, a bfloat16 one naming
``ml_dtypes.bfloat16``.

Writing (:func:`dumps`).  ``pickle.dumps`` would import the module of
every global it names to check it, and this package may not import
``mxnet_tpu``.  So a small emitter of pickle opcodes (protocol 4, no
frames, no memo) writes the payload itself: dicts, lists, tuples, None,
bools, ints, floats, strings, bytes and NDArrays.  An NDArray becomes
``mxnet_tpu.ndarray.ndarray._nd_unpickle(numpy.reshape(
numpy.frombuffer(raw, dtype), shape), "cpu", 0, "default")``, its bytes
C-contiguous from one copy to the host, a bfloat16 array's dtype the
global ``ml_dtypes.bfloat16``.  The JAX package reads it with plain
``pickle.loads``.

Reading (:func:`loads`).  The unpickler maps the names above through a
fixed table to this package's own functions, without importing
``mxnet_tpu`` or ``ml_dtypes``: ``_nd_unpickle`` gives an NDArray on
``cpu(0)``, and ``ml_dtypes.bfloat16`` a marker under which numpy keeps
the raw 2-byte words (:class:`HostArray`) that torch views as bfloat16.
It refuses every other global but the safe builtins and numpy, as the
JAX package's ``_RestrictedUnpickler`` does (``mxnet_tpu/dist_ps.py:213-237``):
:class:`UnpicklingRefused`.

Optimizers (``Updater.get_states(dump_optimizer=True)``).  The JAX
package pickles its optimizer as ``mxnet_tpu.optimizer.<Name>`` built
with ``NEWOBJ`` and filled from its ``__dict__`` (``BUILD``).  Both
packages' optimizers keep the same attributes, so the emitter writes one
of this package's twelve rules (:data:`OPTIMIZERS`) the same way, under
the JAX package's class name, and the reader maps those twelve names to
this package's classes of the same name.  Any other optimizer class is
neither written nor read.
"""
from __future__ import annotations

import builtins
import io
import pickle
import struct

import numpy as np
import torch

from .base import MXNetError, dtype_name
from .ndarray.ndarray import NDArray, _nd_unpickle
from .ndarray.utils import host_bytes

__all__ = ["dumps", "loads", "UnpicklingRefused", "HostArray", "BFLOAT16",
           "SAFE_BUILTINS", "OPTIMIZERS"]

SAFE_BUILTINS = frozenset({
    "dict", "list", "tuple", "set", "frozenset", "str", "int", "float",
    "bool", "bytes", "bytearray", "complex", "slice", "range",
})

_ND_UNPICKLE = ("mxnet_tpu.ndarray.ndarray", "_nd_unpickle")
_OPTIMIZER_MODULE = "mxnet_tpu.optimizer"
# the rules whose pickled optimizer both packages read
OPTIMIZERS = frozenset({
    "SGD", "NAG", "SGLD", "DCASGD", "Adam", "AdaGrad", "RMSProp",
    "AdaDelta", "Ftrl", "Adamax", "Nadam", "Signum",
})


def _optimizer_class(name):
    """This package's optimizer class ``name`` (one of :data:`OPTIMIZERS`),
    or None."""
    from . import optimizer  # imports this module
    return getattr(optimizer, name) if name in OPTIMIZERS else None


class UnpicklingRefused(MXNetError, pickle.UnpicklingError):
    """A pickle names a global outside the safe builtins, numpy and the
    package's table."""


class _BFloat16:
    """Stands for ``ml_dtypes.bfloat16`` and the numpy dtype made of it."""

    def __setstate__(self, state):
        """numpy's dtype state (byte order, sizes): nothing to keep."""

    def __repr__(self):
        return "bfloat16"


BFLOAT16 = _BFloat16()


class HostArray(np.ndarray):
    """A numpy array rebuilt from a pickle.  Where the pickle held
    bfloat16, which numpy lacks, the array holds the raw 2-byte words as
    int16 and ``bfloat16`` is True."""
    bfloat16 = False

    def __array_finalize__(self, obj):
        self.bfloat16 = getattr(obj, "bfloat16", False)

    def __setstate__(self, state):
        at = 2 if len(state) == 5 else 1  # (version,) shape, dtype, ...
        if state[at] is BFLOAT16:
            state = state[:at] + (np.dtype("<i2"),) + state[at + 1:]
            self.bfloat16 = True
        super().__setstate__(state)


def _bf16_words(buf, count=-1, offset=0):
    out = np.frombuffer(buf, dtype="<i2", count=count, offset=offset) \
        .view(HostArray)
    out.bfloat16 = True
    return out


def _dtype(obj, *args):
    return BFLOAT16 if obj is BFLOAT16 else np.dtype(obj, *args)


def _frombuffer(buf, dtype=float, count=-1, offset=0, **kw):
    if dtype is BFLOAT16:
        return _bf16_words(buf, count, offset)
    return np.frombuffer(buf, dtype=dtype, count=count, offset=offset, **kw)


def _frombuffer_v5(buf, dtype, shape, order):
    """numpy's protocol-5 reduction (``numpy._core.numeric._frombuffer``)."""
    flat = _bf16_words(buf) if dtype is BFLOAT16 \
        else np.frombuffer(buf, dtype=dtype)
    return flat.reshape(shape, order=order)


def _reconstruct(subtype, shape, typecode):
    """numpy's protocol 2-4 reduction (``multiarray._reconstruct``): an
    empty array that the pickle's state then fills."""
    return np.ndarray.__new__(HostArray, shape, typecode)


# the globals a state pickle names, mapped to this package's functions
_TABLE = {
    _ND_UNPICKLE: _nd_unpickle,
    ("ml_dtypes", "bfloat16"): BFLOAT16,
    ("numpy", "dtype"): _dtype,
    ("numpy", "frombuffer"): _frombuffer,
    ("numpy.core.multiarray", "_reconstruct"): _reconstruct,
    ("numpy._core.multiarray", "_reconstruct"): _reconstruct,
    ("numpy.core.numeric", "_frombuffer"): _frombuffer_v5,
    ("numpy._core.numeric", "_frombuffer"): _frombuffer_v5,
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _TABLE:
            return _TABLE[(module, name)]
        if module == _OPTIMIZER_MODULE and _optimizer_class(name):
            return _optimizer_class(name)
        if module.split(".", 1)[0] == "numpy":
            return super().find_class(module, name)
        if module == "builtins" and name in SAFE_BUILTINS:
            return getattr(builtins, name)
        raise UnpicklingRefused("disallowed pickle global %s.%s"
                                % (module, name))


def loads(blob):
    """Unpickle ``blob`` through the restricted table."""
    return _Unpickler(io.BytesIO(blob)).load()


# -- the emitter -------------------------------------------------------------
def _global(out, module, name):
    out.append(b"c%s\n%s\n" % (module.encode(), name.encode()))


def _emit_array(out, arr):
    t = arr._data
    _global(out, *_ND_UNPICKLE)
    out.append(b"(")
    _global(out, "numpy", "reshape")
    _global(out, "numpy", "frombuffer")
    _emit(out, host_bytes(t))
    if t.dtype == torch.bfloat16:
        _global(out, "ml_dtypes", "bfloat16")
    else:
        _emit(out, dtype_name(t.dtype))
    out.append(b"\x86R")  # TUPLE2 REDUCE: frombuffer(raw, dtype)
    _emit(out, tuple(int(s) for s in t.shape))
    out.append(b"\x86R")  # reshape(flat, shape)
    for v in ("cpu", 0, "default"):
        _emit(out, v)
    out.append(b"tR")  # TUPLE REDUCE: _nd_unpickle(npy, "cpu", 0, "default")


def _emit(out, obj):
    if obj is None:
        out.append(b"N")
    elif obj is True or obj is False:
        out.append(b"\x88" if obj else b"\x89")
    elif isinstance(obj, int):
        if -2 ** 31 <= obj < 2 ** 31:
            out.append(b"J" + struct.pack("<i", obj))
        else:
            raw = obj.to_bytes((obj.bit_length() + 8) // 8, "little",
                               signed=True)
            out.append(b"\x8a" + bytes([len(raw)]) + raw)  # LONG1
    elif isinstance(obj, float):
        out.append(b"G" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(b"X" + struct.pack("<I", len(raw)) + raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(b"\x8e" + struct.pack("<Q", len(obj)))  # BINBYTES8
        out.append(bytes(obj))
    elif isinstance(obj, tuple):
        if not obj:
            out.append(b")")
            return
        if len(obj) > 3:
            out.append(b"(")
        for v in obj:
            _emit(out, v)
        out.append({1: b"\x85", 2: b"\x86", 3: b"\x87"}.get(len(obj), b"t"))
    elif isinstance(obj, list):
        out.append(b"]")
        if obj:
            out.append(b"(")
            for v in obj:
                _emit(out, v)
            out.append(b"e")  # APPENDS
    elif isinstance(obj, dict):
        out.append(b"}")
        if obj:
            out.append(b"(")
            for k, v in obj.items():
                _emit(out, k)
                _emit(out, v)
            out.append(b"u")  # SETITEMS
    elif isinstance(obj, NDArray):
        _emit_array(out, obj)
    elif _optimizer_class(type(obj).__name__) is type(obj):
        _global(out, _OPTIMIZER_MODULE, type(obj).__name__)
        out.append(b")\x81")  # EMPTY_TUPLE NEWOBJ: cls.__new__(cls)
        _emit(out, dict(vars(obj)))
        out.append(b"b")  # BUILD: its __dict__
    else:
        raise TypeError("cannot write %s into a state pickle"
                        % type(obj).__name__)


def dumps(obj):
    """``obj`` (dicts, lists, tuples, None, bools, ints, floats, strings,
    bytes, NDArrays and the optimizers of :data:`OPTIMIZERS`) as a pickle
    that both packages read."""
    out = [b"\x80\x04"]  # PROTO 4
    _emit(out, obj)
    out.append(b".")
    return b"".join(out)
