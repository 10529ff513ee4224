"""RecordIO: MXNet's packed binary record format.

Counterpart of ``mxnet_tpu/recordio.py`` (``MXRecordIO``:29,
``MXIndexedRecordIO``:167, ``IRHeader``, ``pack``:227, ``unpack``:243,
``unpack_img``:254, ``pack_img``:262), over dmlc-core's format: each
record is ``[kMagic:u32][lrec:u32][data][pad to 4 bytes]``, ``lrec`` the
cflag (upper 3 bits, 0 = a complete record) and the length (lower 29).
Files either package writes, the other reads, byte for byte.

A local path (bare or ``file://``) goes through the native codec
(``_native/csrc/recordio.cc``, built at first use); a URI with another
scheme (``mem://``, or one registered with ``stream.register_scheme``)
through :class:`_PyCodec`, the same wire format in Python, as the JAX
package routes them.  ``pack_img`` encodes JPEG with the package's
libjpeg binding (``_native.jpeg_encode``).  ``unpack_img`` and
``decode_image`` pick the JPEG decoder from the context, as
``ImageRecordIter`` does (``image/native_iter.py``): on a ``gpu`` context
nvJPEG on that card (``ops.image_nvjpeg.decode_jpeg``), on ``cpu()``
libjpeg (``_native.jpeg_decode``), bit for bit the JAX package's decode;
a decoder that cannot be built raises naming itself, with no switch to
the other.  Other formats go through PIL where it is installed, else
raise naming the format.  Images are given and taken in BGR order, as
MXNet's cv2 path does.
"""
from __future__ import annotations

import collections
import ctypes
import io as _pyio
import struct

import numpy as np

from .base import MXNetError
from . import _native
from .context import as_context
from .ops import image_nvjpeg as _nvjpeg
from .stream import open_stream, split_scheme

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img"]

_KMAGIC = 0xced7230a
_LEN_MASK = (1 << 29) - 1


class _NativeCodec:
    """The native codec's handle for one local file."""

    def __init__(self, path, writable):
        self._lib = _native.recordio_lib()
        self.writable = writable
        create = (self._lib.MXRIOWriterCreate if writable
                  else self._lib.MXRIOReaderCreate)
        self._h = create(path.encode())
        if not self._h:
            raise IOError("cannot open %s" % path)

    def close(self):
        if self._h:
            (self._lib.MXRIOWriterFree if self.writable
             else self._lib.MXRIOReaderFree)(self._h)
            self._h = None

    def write(self, buf):
        buf = bytes(buf)
        if self._lib.MXRIOWrite(self._h, buf, len(buf)) != 0:
            raise IOError("RecordIO write failed")

    def read(self):
        out, n = ctypes.c_char_p(), ctypes.c_uint64()
        status = self._lib.MXRIORead(self._h, ctypes.byref(out),
                                     ctypes.byref(n))
        if status == 0:
            return None
        if status < 0:
            raise IOError("corrupt RecordIO stream")
        return ctypes.string_at(out, n.value)

    def seek(self, pos):
        if self._lib.MXRIOReaderSeek(self._h, pos) != 0:
            raise IOError("seek(%d) failed" % pos)

    def tell(self):
        return (self._lib.MXRIOWriterTell if self.writable
                else self._lib.MXRIOReaderTell)(self._h)


class _PyCodec:
    """The same wire format over any stream ``stream.open_stream`` opens."""

    def __init__(self, uri, writable):
        self.fd = open_stream(uri, "wb" if writable else "rb")

    def close(self):
        self.fd.close()

    def write(self, buf):
        n = len(buf)
        if n > _LEN_MASK:
            raise IOError("RecordIO write failed: a record of %d bytes" % n)
        self.fd.write(struct.pack("<II", _KMAGIC, n))   # cflag 0
        self.fd.write(bytes(buf))
        pad = (4 - n % 4) % 4
        if pad:
            self.fd.write(b"\x00" * pad)

    def read(self):
        head = self.fd.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _KMAGIC or lrec >> 29 != 0:
            raise IOError("corrupt RecordIO stream")
        n = lrec & _LEN_MASK
        buf = self.fd.read(n)
        if len(buf) != n:
            raise IOError("corrupt RecordIO stream")
        pad = (4 - n % 4) % 4
        if pad:
            self.fd.read(pad)
        return buf

    def seek(self, pos):
        self.fd.seek(pos)

    def tell(self):
        return self.fd.tell()


class MXRecordIO:
    """Sequential reader (``flag="r"``) or writer (``"w"``) of a RecordIO
    file or URI."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.is_open = False
        self._codec = None
        self.open()

    def open(self):
        if self.flag not in ("r", "w"):
            raise ValueError("Invalid flag %s" % self.flag)
        self.writable = self.flag == "w"
        scheme, rest = split_scheme(self.uri)
        if scheme in (None, "file"):
            self._codec = _NativeCodec(rest, self.writable)
        else:
            self._codec = _PyCodec(self.uri, self.writable)
        self.is_open = True

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("_codec", None)
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        self._codec = None
        is_open = d.get("is_open", False)
        self.is_open = False
        if is_open:
            self.open()

    def close(self):
        if not getattr(self, "is_open", False):
            return
        self._codec.close()
        self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        self._codec.write(buf)

    def read(self):
        """The next record's bytes, or None at the end of the file."""
        assert not self.writable
        return self._codec.read()

    def seek(self, pos):
        assert not self.writable
        self._codec.seek(pos)

    def tell(self):
        return self._codec.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access RecordIO with a ``.idx`` sidecar (``key\\toffset``
    lines)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.writable:
            return
        try:
            fin = open_stream(self.idx_path, "r")
        except (OSError, MXNetError):
            return                      # the sidecar is optional
        with fin:
            for line in fin.readlines():
                key, pos = line.strip().split("\t")
                key = self.key_type(key)
                self.idx[key] = int(pos)
                self.keys.append(key)

    def close(self):
        if not getattr(self, "is_open", False):
            return
        if self.writable:
            with open_stream(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        super().close()

    def seek(self, idx):
        assert not self.writable
        super().seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.keys.append(key)
        self.idx[key] = pos


IRHeader = collections.namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Prefix ``s`` with an IRHeader; a label array goes after the header
    as float32, its length in ``flag``."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        ret = struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                          header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        ret = struct.pack(_IR_FORMAT, label.size, 0, header.id, header.id2)
        ret += label.tobytes()
    return ret + s


def unpack(s):
    """(IRHeader, payload) of a packed record; a label array comes back as
    float32 numpy."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


_MAGIC = ((b"\xff\xd8", "JPEG"), (b"\x89PNG", "PNG"), (b"GIF8", "GIF"),
          (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


def image_format(buf):
    """The format named by ``buf``'s leading bytes, or "unknown"."""
    head = bytes(buf[:4])
    return next((name for magic, name in _MAGIC if head.startswith(magic)),
                "unknown")


def _pil():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def decode_image(buf, flag=1, ctx=None):
    """HWC uint8 RGB (or one-channel) numpy of encoded image bytes:
    ``flag`` 1 color, 0 grayscale, -1 as stored.  JPEG through nvJPEG on
    a ``gpu`` ``ctx`` (default: the current context, so the card) or
    libjpeg on ``cpu()``; another format through PIL where it is
    installed."""
    fmt = image_format(buf)
    if fmt == "JPEG":
        ctx = as_context(ctx)
        if ctx.device_type == "gpu":
            return _nvjpeg.decode_jpeg(buf, flag, ctx.device_id)
        return _native.jpeg_decode(buf, flag)
    image = _pil()
    if image is None:
        raise MXNetError("decoding a %s image needs PIL, which is not "
                         "installed (libjpeg serves JPEG only)" % fmt)
    try:
        img = image.open(_pyio.BytesIO(bytes(buf)))
        if flag == 1:
            img = img.convert("RGB")
        elif flag == 0:
            img = img.convert("L")
        arr = np.asarray(img, dtype=np.uint8)
    except Exception as e:   # PIL raises its own types for bad bytes
        raise MXNetError("Decoding image failed: %s" % e) from e
    return arr[:, :, None] if arr.ndim == 2 else arr


def encode_image(img, quality=95, img_fmt=".jpg"):
    """Bytes of an HWC uint8 RGB (or one-channel) image: ``.jpg``/``.jpeg``
    through libjpeg, ``.png`` through PIL where it is installed."""
    fmt = img_fmt.lower()
    if fmt in (".jpg", ".jpeg"):
        return _native.jpeg_encode(img, quality)
    image = _pil()
    if image is None or fmt != ".png":
        raise MXNetError("encoding %s needs PIL%s (libjpeg serves JPEG only)"
                         % (img_fmt, "" if image is None else
                            ", which writes .png here"))
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    bio = _pyio.BytesIO()
    image.fromarray(arr).save(bio, format="PNG")
    return bio.getvalue()


def _flip_channels(arr):
    return arr[:, :, ::-1] if arr.ndim == 3 and arr.shape[2] == 3 else arr


def unpack_img(s, iscolor=-1, ctx=None):
    """(IRHeader, HWC uint8 image in BGR order) of a packed image record,
    as MXNet's ``cv2.imdecode`` gives it, decoded as ``decode_image``
    decodes on ``ctx``."""
    header, s = unpack(s)
    img = decode_image(s, iscolor, ctx)
    img = np.ascontiguousarray(_flip_channels(img))
    return header, img[:, :, 0] if img.shape[2] == 1 else img


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HWC uint8 image given in BGR order (MXNet's cv2
    convention) and pack it with ``header``."""
    img = np.asarray(img, dtype=np.uint8)
    return pack(header, encode_image(_flip_channels(img), quality, img_fmt))
