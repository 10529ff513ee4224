"""NDArray save/load in the reference's binary format.

Counterpart of ``mxnet_tpu/ndarray/utils.py``: the same bytes
(``src/ndarray/ndarray.cc`` Save at :826, the list container at :1022),
so a file either package writes loads in the other, and MXNet v0.12
``.params`` files load too.  For the same list or dict of arrays,
:func:`save_to_bytes` gives the JAX package's bytes exactly.

Layout (little-endian):
  file   := uint64 0x112 (kMXAPINDArrayListMagic) | uint64 reserved
          | uint64 n | NDArray*n | uint64 nkeys | (uint64 len | bytes)*nkeys
  ndarray:= uint32 0xF993fac9 (NDARRAY_V2_MAGIC) | int32 stype(0=dense)
          | shape | int32 dev_type | int32 dev_id | int32 type_flag | raw data
  shape  := uint32 ndim | int64 dim[ndim]          (nnvm::TShape::Save)

Legacy records also load (reference LegacyLoad, ndarray.cc:892-937):
  V1     := uint32 0xF993fac8 | shape | context | type_flag | raw data
  V0     := uint32 ndim | uint32 dim[ndim] | context | type_flag | raw data

Every array is written with the context ``cpu(0)`` and its data
C-contiguous, copied to the host once; a sparse array as its dense
record (stype 0), as the JAX package writes it, and a sparse record
raises on load in both packages.  bfloat16 (type code 7), which
numpy lacks, goes to and from the file as its raw 2-byte words through
torch.  :func:`load` returns arrays on ``cpu(0)``, as the reference does;
``Module.set_params`` and ``Parameter.set_data`` copy them to their own
context.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..base import MXNetError, CODE_TO_DTYPE, DTYPE_TO_CODE, dtype_name
from ..context import cpu
from .ndarray import NDArray

__all__ = ["save", "load", "save_to_bytes", "load_from_bytes"]

_LIST_MAGIC = 0x112
_V2_MAGIC = 0xF993FAC9
_V1_MAGIC = 0xF993FAC8


def host_bytes(tensor):
    """The C-contiguous bytes of ``tensor`` on the host (one copy from the
    card); bfloat16 as its raw 2-byte words."""
    t = tensor.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _write_shape(buf, shape):
    buf.append(struct.pack("<I", len(shape)))
    if shape:
        buf.append(struct.pack("<%dq" % len(shape), *shape))


def _read_shape(mv, off):
    (ndim,) = struct.unpack_from("<I", mv, off)
    off += 4
    dims = struct.unpack_from("<%dq" % ndim, mv, off) if ndim else ()
    off += 8 * ndim
    return tuple(dims), off


def _save_one(buf, arr):
    if not isinstance(arr, NDArray):
        raise TypeError("save takes NDArrays, got %s" % type(arr).__name__)
    if arr.stype != "default":   # the dense record, as the JAX package
        arr = arr.tostype("default")
    code = DTYPE_TO_CODE.get(arr._data.dtype)
    if code is None:
        raise MXNetError("cannot save an NDArray of dtype %s"
                         % arr._data.dtype)
    buf.append(struct.pack("<I", _V2_MAGIC))
    buf.append(struct.pack("<i", 0))  # kDefaultStorage
    _write_shape(buf, arr.shape)
    buf.append(struct.pack("<ii", 1, 0))  # Context: cpu(0)
    buf.append(struct.pack("<i", code))
    buf.append(host_bytes(arr._data))


def _load_legacy(mv, off, magic):
    """V1 / V0 NDArray records (reference NDArray::LegacyLoad,
    src/ndarray/ndarray.cc:908-937 over LegacyTShapeLoad :892).

    V1 (magic 0xF993FAC8): shape is the V2 TShape (uint32 ndim + int64
    dims). V0 has NO magic: the word already read IS ndim, followed by
    uint32 dims. Both then carry context, type_flag, raw data like V2.
    """
    if magic == _V1_MAGIC:
        shape, off = _read_shape(mv, off)
    else:
        ndim = magic
        if ndim > 32:  # not a plausible legacy ndim -> corrupt/unknown
            raise MXNetError("invalid NDArray save format: bad magic 0x%x"
                             % magic)
        shape = struct.unpack_from("<%dI" % ndim, mv, off) if ndim else ()
        off += 4 * ndim
        shape = tuple(int(d) for d in shape)
    if not shape:
        # the reference's reading of an empty legacy record: an empty
        # float32 array, and nothing more of the record is consumed
        return NDArray(torch.zeros((0,), dtype=torch.float32), cpu()), off
    return _read_body(mv, off, shape)


def _read_body(mv, off, shape):
    """context | type_flag | raw data, shared by every format version."""
    off += 8  # the context: the array is placed on cpu(0)
    (type_flag,) = struct.unpack_from("<i", mv, off)
    off += 4
    dtype = CODE_TO_DTYPE[type_flag]
    raw = torch.int16 if dtype == torch.bfloat16 else dtype
    count = int(np.prod(shape)) if shape else 1
    words = np.frombuffer(mv, dtype=np.dtype(dtype_name(raw)), count=count,
                          offset=off)
    off += words.nbytes
    data = torch.from_numpy(words.copy()).view(dtype).reshape(shape)
    return NDArray(data, cpu()), off


def _load_one(mv, off):
    (magic,) = struct.unpack_from("<I", mv, off)
    off += 4
    if magic != _V2_MAGIC:
        return _load_legacy(mv, off, magic)
    (stype,) = struct.unpack_from("<i", mv, off)
    off += 4
    if stype != 0:
        raise MXNetError("sparse NDArray load not supported yet")
    shape, off = _read_shape(mv, off)
    return _read_body(mv, off, shape)


def _pieces(data):
    """The file's bytes, in pieces: header, records, keys."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        keys = list(data.keys())
        arrays = [data[k] for k in keys]
    else:
        keys = []
        arrays = list(data)
    buf = [struct.pack("<QQ", _LIST_MAGIC, 0), struct.pack("<Q", len(arrays))]
    for a in arrays:
        _save_one(buf, a)
    buf.append(struct.pack("<Q", len(keys)))
    for k in keys:
        kb = k.encode("utf-8")
        buf.append(struct.pack("<Q", len(kb)))
        buf.append(kb)
    return buf


def save_to_bytes(data):
    """An NDArray, a list of them or a dict of them by name, as the bytes
    of an ``nd.save`` file."""
    return b"".join(_pieces(data))


def save(fname, data):
    """Save an NDArray, a list or a dict of them (reference ``mx.nd.save``).
    Scheme URIs (``mem://``, or one registered with
    ``stream.register_scheme``) go through :mod:`mxnet_tpu_torch.stream`."""
    from ..stream import open_stream
    pieces = _pieces(data)
    with open_stream(fname, "wb") as f:
        for piece in pieces:
            f.write(piece)


def load_from_bytes(raw):
    """The list (or dict, where the file names its arrays) of NDArrays on
    ``cpu(0)`` in ``raw``; a truncated or garbage payload raises
    :class:`MXNetError`."""
    try:
        mv = memoryview(raw)
        header, _res = struct.unpack_from("<QQ", mv, 0)
        if header != _LIST_MAGIC:
            raise MXNetError("Invalid NDArray file format")
        (n,) = struct.unpack_from("<Q", mv, 16)
        off = 24
        arrays = []
        for _ in range(n):
            a, off = _load_one(mv, off)
            arrays.append(a)
        (nkeys,) = struct.unpack_from("<Q", mv, off)
        off += 8
        keys = []
        for _ in range(nkeys):
            (ln,) = struct.unpack_from("<Q", mv, off)
            off += 8
            keys.append(bytes(mv[off:off + ln]).decode("utf-8"))
            off += ln
    except MXNetError:
        raise
    except (struct.error, IndexError, KeyError, UnicodeDecodeError,
            ValueError, OverflowError, RuntimeError) as exc:
        # truncated/garbage payloads fail as a format error, not with
        # struct's or numpy's internals
        raise MXNetError("Invalid NDArray file format: %s" % exc) from exc
    if keys:
        return dict(zip(keys, arrays))
    return arrays


def load(fname):
    """Load a list or dict of NDArrays (reference ``mx.nd.load``), on
    ``cpu(0)``.  Scheme URIs go through :mod:`mxnet_tpu_torch.stream`."""
    from ..stream import open_stream
    with open_stream(fname, "rb") as f:
        return load_from_bytes(f.read())
