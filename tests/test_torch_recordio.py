"""``recordio`` of the PyTorch package against the JAX package on the CPU,
case for case with ``tests/test_io.py``'s record cases (round trip,
indexed seek, IRHeader, images, the native codec, empty and bytearray
records): files either package writes, the other reads byte for byte;
the native codec (local paths) and the Python codec (``mem://`` and
other schemes) write the same bytes; ``pack_img``/``unpack_img`` go
through the package's libjpeg binding, in MXNet's BGR order.
"""
import os
import struct

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, recordio


@pytest.fixture(autouse=True)
def _decode_on_the_cpu():
    """JPEG decodes on the current context, the card by default: these
    cases hold the ``cpu()`` route (libjpeg) to the JAX package."""
    with mt.cpu():
        yield


PAYLOADS = [b"", b"a", b"abc", b"abcd", os.urandom(1000), b"rec%d" % 7]


def _write(pkg, path, payloads):
    rec = pkg.recordio.MXRecordIO(path, "w")
    for p in payloads:
        rec.write(p)
    rec.close()


def _read_all(pkg, path):
    rec = pkg.recordio.MXRecordIO(path, "r")
    out = []
    while True:
        buf = rec.read()
        if buf is None:
            break
        out.append(buf)
    rec.close()
    return out


@pytest.mark.parametrize("writer,reader", [(mt, mx), (mx, mt), (mt, mt)])
def test_recordio_roundtrip_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "x.rec")
    _write(writer, path, PAYLOADS)
    assert _read_all(reader, path) == PAYLOADS


def test_files_are_byte_for_byte(tmp_path):
    a, b = str(tmp_path / "port.rec"), str(tmp_path / "jax.rec")
    _write(mt, a, PAYLOADS)
    _write(mx, b, PAYLOADS)
    assert open(a, "rb").read() == open(b, "rb").read()
    # the wire format itself: magic, length, payload, pad to 4 bytes
    want = b"".join(struct.pack("<II", 0xced7230a, len(p)) + p
                    + b"\x00" * ((4 - len(p) % 4) % 4) for p in PAYLOADS)
    assert open(a, "rb").read() == want


def test_native_and_python_codecs_agree(tmp_path):
    local = str(tmp_path / "n.rec")
    rec = recordio.MXRecordIO(local, "w")
    assert isinstance(rec._codec, recordio._NativeCodec)
    for p in PAYLOADS:
        rec.write(p)
    rec.close()
    mem = "mem://codec_agree.rec"
    rec = recordio.MXRecordIO(mem, "w")
    assert isinstance(rec._codec, recordio._PyCodec)
    for p in PAYLOADS:
        rec.write(p)
    rec.close()
    with mt.stream.open_stream(mem, "rb") as f:
        assert f.read() == open(local, "rb").read()
    assert _read_all(mt, mem) == PAYLOADS
    # file:// goes native as well
    assert _read_all(mt, "file://" + local) == PAYLOADS


@pytest.mark.parametrize("uri", ["local", "mem"])
def test_indexed_recordio_seek(tmp_path, uri):
    if uri == "local":
        path, idx = str(tmp_path / "y.rec"), str(tmp_path / "y.idx")
    else:
        path, idx = "mem://seek_y.rec", "mem://seek_y.idx"
    rec = recordio.MXIndexedRecordIO(idx, path, "w")
    for i in range(6):
        rec.write_idx(i, b"item%d" % i)
    rec.close()
    rec = recordio.MXIndexedRecordIO(idx, path, "r")
    assert rec.read_idx(4) == b"item4"
    assert rec.read_idx(1) == b"item1"
    assert sorted(rec.keys) == list(range(6))
    rec.close()
    if uri == "local":
        jax_rec = mx.recordio.MXIndexedRecordIO(idx, path, "r")
        assert jax_rec.idx == rec.idx
        assert jax_rec.read_idx(3) == b"item3"
        jax_rec.close()


def test_indexed_idx_file_matches_jax(tmp_path):
    for pkg, name in ((mt, "p"), (mx, "j")):
        rec = pkg.recordio.MXIndexedRecordIO(str(tmp_path / (name + ".idx")),
                                             str(tmp_path / (name + ".rec")),
                                             "w")
        for i, p in enumerate(PAYLOADS):
            rec.write_idx(i, p)
        rec.close()
    for ext in (".idx", ".rec"):
        assert (tmp_path / ("p" + ext)).read_bytes() == \
            (tmp_path / ("j" + ext)).read_bytes()


@pytest.mark.parametrize("label", [3.0, 7, [1.0, 2.0], [0.5, -1.0, 2.5]])
def test_irheader_pack_unpack(label):
    header = recordio.IRHeader(0, label, 7, 3)
    s = recordio.pack(header, b"payload")
    assert s == mx.recordio.pack(mx.recordio.IRHeader(0, label, 7, 3),
                                 b"payload")
    h2, blob = recordio.unpack(s)
    jh, jblob = mx.recordio.unpack(s)
    np.testing.assert_array_equal(np.asarray(h2.label),
                                  np.asarray(jh.label))
    assert (h2.flag, h2.id, h2.id2, blob) == (jh.flag, jh.id, jh.id2, jblob)
    assert h2.id == 7 and blob == b"payload"


def test_pack_img_unpack_img_jpeg():
    """pack_img encodes with libjpeg; unpack_img decodes with it and gives
    BGR back (MXNet's cv2 order), so a round trip keeps the channels."""
    yy, xx = np.mgrid[0:16, 0:24]
    img = np.stack([yy * 12, xx * 8, 255 - yy * 6 - xx * 4],
                   -1).astype(np.uint8)    # smooth: chroma subsampling
    header = recordio.IRHeader(0, 3.0, 1, 0)
    s = recordio.pack_img(header, img, quality=95, img_fmt=".jpg")
    h2, img2 = recordio.unpack_img(s)
    assert float(np.asarray(h2.label)) == 3.0
    assert img2.shape == (16, 24, 3) and img2.dtype == np.uint8
    assert np.abs(img2.astype(int) - img.astype(int)).mean() < 3
    # the payload is libjpeg's encoding of the RGB-ordered image
    _, payload = recordio.unpack(s)
    assert payload == mt._native.jpeg_encode(img[:, :, ::-1], 95)
    # the JAX package reads the record through cv2: BGR as well
    pytest.importorskip("cv2")
    _, jimg = mx.recordio.unpack_img(s)
    np.testing.assert_array_equal(jimg, img2)


def test_pack_img_png_and_grayscale():
    pytest.importorskip("PIL")
    rng = np.random.RandomState(1)
    img = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
    s = recordio.pack_img(recordio.IRHeader(0, 1.0, 0, 0), img,
                          img_fmt=".png")
    _, back = recordio.unpack_img(s)
    np.testing.assert_array_equal(back, img)       # PNG is lossless
    gray = (rng.rand(8, 8) * 255).astype(np.uint8)
    s = recordio.pack_img(recordio.IRHeader(0, 1.0, 0, 0), gray)
    _, back = recordio.unpack_img(s)
    assert back.shape == (8, 8)
    assert np.abs(back.astype(int) - gray.astype(int)).mean() < 4


def test_corrupt_image_payload_raises():
    s = recordio.pack(recordio.IRHeader(0, 1.0, 0, 0), b"\xff\xd8 broken")
    with pytest.raises(MXNetError, match="Decoding image failed"):
        recordio.unpack_img(s)


def test_recordio_empty_record_not_eof(tmp_path):
    for uri in (str(tmp_path / "e.rec"), "mem://empty_e.rec"):
        w = recordio.MXRecordIO(uri, "w")
        w.write(b"")
        w.write(b"after")
        w.close()
        r = recordio.MXRecordIO(uri, "r")
        assert r.read() == b""
        assert r.read() == b"after"
        assert r.read() is None
        r.close()


def test_recordio_bytearray_payload(tmp_path):
    p = str(tmp_path / "ba.rec")
    w = recordio.MXRecordIO(p, "w")
    w.write(bytearray(b"abc"))
    w.write(memoryview(b"defg"))
    w.close()
    assert _read_all(mt, p) == [b"abc", b"defg"]


def test_tell_seek_and_reset(tmp_path):
    p = str(tmp_path / "t.rec")
    w = recordio.MXRecordIO(p, "w")
    offsets = []
    for b in PAYLOADS:
        offsets.append(w.tell())
        w.write(b)
    w.close()
    r = recordio.MXRecordIO(p, "r")
    r.seek(offsets[4])
    assert r.read() == PAYLOADS[4]
    r.reset()
    assert r.read() == PAYLOADS[0]
    r.close()
    with pytest.raises(ValueError):
        recordio.MXRecordIO(p, "x")


def test_corrupt_stream_raises(tmp_path):
    p = tmp_path / "bad.rec"
    p.write_bytes(b"\x00" * 16)
    with pytest.raises(IOError, match="corrupt"):
        recordio.MXRecordIO(str(p), "r").read()


def test_pickled_reader_reopens(tmp_path):
    import pickle
    p = str(tmp_path / "pk.rec")
    _write(mt, p, PAYLOADS)
    r = recordio.MXRecordIO(p, "r")
    r.read()
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.read() == PAYLOADS[0]
    r2.close()
