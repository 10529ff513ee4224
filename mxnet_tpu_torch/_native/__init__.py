"""ctypes bindings to the package's host C++ (``_native/csrc``).

Counterpart of ``mxnet_tpu/_native/__init__.py``: the RecordIO codec
(``csrc/recordio.cc``) and the threaded image loader with its one-image
JPEG codec (``csrc/image_loader.cc``, linked with libjpeg), each the
package's own copy of the JAX package's source with the same C ABI.
They are built by ``ops._build.load_host_library`` at first use, never
at import; a build that fails raises ``MXNetError`` with the compiler's
log, and no caller falls back to another implementation without saying
so.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..base import MXNetError
from ..ops import _build

__all__ = ["recordio_lib", "image_lib", "jpeg_decode", "jpeg_encode"]

_lock = threading.Lock()
_bound = {}  # stem -> CDLL with its signatures set

_p = ctypes.c_void_p
_SIGNATURES = {
    "recordio": {
        "MXRIOWriterCreate": (_p, [ctypes.c_char_p]),
        "MXRIOWrite": (ctypes.c_int, [_p, ctypes.c_char_p, ctypes.c_uint64]),
        "MXRIOWriterTell": (ctypes.c_int64, [_p]),
        "MXRIOWriterFree": (None, [_p]),
        "MXRIOReaderCreate": (_p, [ctypes.c_char_p]),
        "MXRIORead": (ctypes.c_int, [_p, ctypes.POINTER(ctypes.c_char_p),
                                     ctypes.POINTER(ctypes.c_uint64)]),
        "MXRIOReaderTell": (ctypes.c_int64, [_p]),
        "MXRIOReaderSeek": (ctypes.c_int, [_p, ctypes.c_int64]),
        "MXRIOReaderFree": (None, [_p]),
    },
    "image_loader": {
        "mx_imgloader_create": (_p, [ctypes.c_char_p] + [ctypes.c_int] * 6
                                + [ctypes.c_uint, ctypes.c_int]),
        "mx_imgloader_num_samples": (ctypes.c_int64, [_p]),
        "mx_imgloader_next": (ctypes.c_int, [
            _p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]),
        "mx_imgloader_reset": (None, [_p]),
        "mx_imgloader_destroy": (None, [_p]),
        "mx_imgloader_failures": (ctypes.c_long, [_p]),
        "mx_imgloader_last_failed": (ctypes.c_int, [_p]),
        "mx_jpeg_decode": (ctypes.c_int, [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]),
        "mx_jpeg_encode": (ctypes.c_int, [
            _p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(_p), ctypes.POINTER(ctypes.c_uint64)]),
        "mx_jpeg_free": (None, [_p]),
    },
}


def _bind(stem):
    with _lock:
        lib = _bound.get(stem)
        if lib is None:
            lib = _build.load_host_library(stem)
            for name, (res, args) in _SIGNATURES[stem].items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _bound[stem] = lib
        return lib


def recordio_lib():
    """The RecordIO codec's CDLL (built at first use)."""
    return _bind("recordio")


def image_lib():
    """The libjpeg image loader's and codec's CDLL (built at first use)."""
    return _bind("image_loader")


def _image_lib_or_raise(what):
    try:
        return image_lib()
    except MXNetError as e:
        raise MXNetError("%s needs the libjpeg codec "
                         "(_native/csrc/image_loader.cc), which could not be "
                         "built or loaded: %s" % (what, e)) from e


def jpeg_decode(buf, mode=1):
    """Decode JPEG bytes with libjpeg into an HWC uint8 numpy array in RGB
    order: ``mode`` 1 three channels, 0 one (grayscale), -1 as stored.
    Raises ``MXNetError`` for bytes libjpeg refuses."""
    lib = _image_lib_or_raise("JPEG decoding")
    buf = bytes(buf)
    out, w, h, c = _p(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.mx_jpeg_decode(buf, len(buf), int(mode), ctypes.byref(out),
                          ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(c)) != 0:
        raise MXNetError("Decoding image failed: libjpeg refused %d bytes"
                         % len(buf))
    try:
        n = w.value * h.value * c.value
        flat = np.ctypeslib.as_array(
            ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), (n,)).copy()
    finally:
        lib.mx_jpeg_free(out)
    return flat.reshape(h.value, w.value, c.value)


def jpeg_encode(pixels, quality=95):
    """Encode an HWC (or HW) uint8 array, RGB or grayscale, as JPEG bytes
    with libjpeg at ``quality``."""
    lib = _image_lib_or_raise("JPEG encoding")
    arr = np.ascontiguousarray(pixels, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    out, n = _p(), ctypes.c_uint64()
    if lib.mx_jpeg_encode(arr.ctypes.data, w, h, c, int(quality),
                          ctypes.byref(out), ctypes.byref(n)) != 0:
        raise MXNetError("JPEG encoding failed for an image of shape %s"
                         % (arr.shape,))
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.mx_jpeg_free(out)
