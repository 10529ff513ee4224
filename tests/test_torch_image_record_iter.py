"""``image.ImageRecordIter`` of the PyTorch package on the CPU (libjpeg on
host threads, ``_native/csrc/image_loader.cc``) against the JAX
package's on the same file, bit for bit, case for case with
``tests/test_native_image_loader.py`` (batches and values, the seeded
shuffle with ``reset``, mean and scale, a corrupt payload raising and
``allow_corrupt`` compacting it out), the JPEGs encoded with PIL; a
loader that cannot be built raises ``MXNetError`` naming libjpeg, with
no fallback; the plain version of the card's resize kernel
(``ops.image_nvjpeg.resize_rgb_chw_reference``) gives the host loader's
bits from the same decoded pixels; and libjpeg's error against the
images before encoding, which the card's nvJPEG check is held to, is
printed (``-s``).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, recordio
from mxnet_tpu_torch.ops import _build, image_nvjpeg

PIL = pytest.importorskip("PIL")
JAX_LOADER = pytest.importorskip("mxnet_tpu.image.native_iter")


def _write_rec(path, n=12, hw=24):
    """n JPEG records; label i; image i is a solid gray level."""
    rec = recordio.MXRecordIO(str(path), "w")
    levels = []
    for i in range(n):
        level = int(255 * (i + 1) / (n + 1))
        levels.append(level)
        img = np.full((hw, hw, 3), level, np.uint8)
        rec.write(recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                                mt.test_utils.pil_jpeg(img, 98)))
    rec.close()
    return levels


def _iters(path, **kw):
    port = mt.image.ImageRecordIter(path_imgrec=str(path), ctx=mt.cpu(), **kw)
    ref = mx.image.ImageRecordIter(path_imgrec=str(path), **kw)
    return port, ref


def _drain(it):
    out = []
    while True:
        try:
            b = it.next()
        except StopIteration:
            return out
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))


def _assert_same(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb and da.dtype == db.dtype == np.float32
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(la, lb)


def test_loader_batches_and_values(tmp_path):
    path = tmp_path / "toy.rec"
    levels = _write_rec(path, n=12, hw=24)
    port, ref = _iters(path, data_shape=(3, 16, 16), batch_size=5,
                       preprocess_threads=3)
    assert port.num_samples == ref.num_samples == 12
    assert port.decoder == "libjpeg"
    got = _drain(port)
    _assert_same(got, _drain(ref))
    seen = []
    for arr, labels, pad in got:
        for j in range(arr.shape[0] - pad):
            seen.append(int(labels[j]))
            np.testing.assert_allclose(arr[j].mean(),
                                       levels[int(labels[j])] / 255.0,
                                       atol=0.02)
    assert sorted(seen) == list(range(12))
    assert got[-1][2] == 3 and got[0][0].shape == (5, 3, 16, 16)


@pytest.mark.parametrize("threads", [1, 4])
def test_shuffle_mirror_and_reset(tmp_path, threads):
    prefix = str(tmp_path / "img")
    mt.test_utils.write_image_rec(prefix, 20, seed=1, short=40, classes=10)
    port, ref = _iters(prefix + ".rec", data_shape=(3, 32, 32), batch_size=8,
                       shuffle=True, rand_mirror=True, seed=3,
                       preprocess_threads=threads)
    for _ in range(2):
        _assert_same(_drain(port), _drain(ref))
        port.reset()
        ref.reset()


def test_loader_mean_scale(tmp_path):
    path = tmp_path / "toy.rec"
    _write_rec(path, n=4)
    port, ref = _iters(path, data_shape=(3, 8, 8), batch_size=4,
                       mean_rgb=(10, 20, 30), scale=2.0)
    a, b = _drain(port), _drain(ref)
    _assert_same(a, b)
    assert a[0][0].max() > 1.0


def _corrupt_rec(path):
    rng = np.random.RandomState(0)
    w = recordio.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for i in range(4):
        hdr = recordio.IRHeader(0, float(i + 1), i, 0)
        if i == 2:   # one corrupt record among three valid JPEGs
            w.write_idx(i, recordio.pack(hdr, b"\x89PNG not a jpeg" * 10))
        else:
            img = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
            w.write_idx(i, recordio.pack_img(hdr, img, img_fmt=".jpg"))
    w.close()


def test_non_jpeg_payload_fails_loudly(tmp_path):
    path = str(tmp_path / "bad")
    _corrupt_rec(path)
    port, ref = _iters(path + ".rec", data_shape=(3, 8, 8), batch_size=4)
    for it in (port, ref):
        with pytest.raises(IOError, match="failed to decode"):
            next(it)
    port, ref = _iters(path + ".rec", data_shape=(3, 8, 8), batch_size=4,
                       allow_corrupt=True)
    a, b = _drain(port), _drain(ref)
    _assert_same(a, b)
    kept = 4 - a[0][2]
    assert kept == 3
    assert sorted(a[0][1][:kept].tolist()) == [1.0, 2.0, 4.0]
    assert port.num_failed == ref.num_failed == 1
    # an all-corrupt file ends the epoch cleanly
    path2 = str(tmp_path / "allbad")
    w = recordio.MXIndexedRecordIO(path2 + ".idx", path2 + ".rec", "w")
    for i in range(3):
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, 1.0, i, 0),
                                     b"nope" * 20))
    w.close()
    it = mt.image.ImageRecordIter(path_imgrec=path2 + ".rec",
                                  data_shape=(3, 8, 8), batch_size=2,
                                  allow_corrupt=True, ctx=mt.cpu())
    with pytest.raises(StopIteration):
        next(it)
    assert it.num_failed == 3


def test_missing_file_raises(tmp_path):
    with pytest.raises(IOError, match="cannot open"):
        mt.image.ImageRecordIter(path_imgrec=str(tmp_path / "none.rec"),
                                 data_shape=(3, 8, 8), batch_size=2,
                                 ctx=mt.cpu())


def test_build_failure_raises_without_fallback(tmp_path, monkeypatch):
    """A loader whose build fails raises MXNetError naming libjpeg (the
    CPU's decoder); nothing falls back to another decoder."""
    path = tmp_path / "toy.rec"
    _write_rec(path, n=2)

    def broken(stem, host=False):
        raise MXNetError("g++ failed on %s.cc (rc 1): jpeglib.h: No such "
                         "file or directory" % stem)
    monkeypatch.setattr(_build, "load_library", broken)
    monkeypatch.setattr(mt._native, "_bound", {})
    with pytest.raises(MXNetError, match="libjpeg.*jpeglib.h"):
        mt.image.ImageRecordIter(path_imgrec=str(path), data_shape=(3, 8, 8),
                                 batch_size=2, ctx=mt.cpu())


def test_card_route_needs_a_card(tmp_path):
    """The default context is the card: without one the iterator raises
    rather than decoding on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = tmp_path / "toy.rec"
    _write_rec(path, n=2)
    with pytest.raises(MXNetError, match="CUDA device"):
        mt.image.ImageRecordIter(path_imgrec=str(path), data_shape=(3, 8, 8),
                                 batch_size=2)


@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("shape", [(3, 24, 20), (4, 7, 9)])
def test_resize_reference_is_the_loaders_formula(tmp_path, mirror, shape):
    """From the pixels libjpeg decodes, the resize kernel's plain version
    gives the host loader's batch bit for bit (the card's kernel is held
    to the plain version in chip_smoke.py)."""
    prefix = str(tmp_path / "r")
    mt.test_utils.write_image_rec(prefix, 3, seed=4, short=30)
    c, h, w = shape
    it = mt.image.ImageRecordIter(path_imgrec=prefix + ".rec",
                                  data_shape=shape, batch_size=3,
                                  ctx=mt.cpu(), rand_mirror=mirror, seed=9)
    got = it.next().data[0].asnumpy()
    rec = recordio.MXRecordIO(prefix + ".rec", "r")
    for i in range(3):
        _, jpg = recordio.unpack(rec.read())
        rgb = torch.from_numpy(mt._native.jpeg_decode(jpg, 1))
        want = [image_nvjpeg.resize_rgb_chw(rgb, h, w, c, m).numpy()
                for m in (False, True)]
        assert any(np.array_equal(got[i], x) for x in want)
        if not mirror:
            np.testing.assert_array_equal(got[i], want[0])


def test_libjpeg_error_against_the_images(tmp_path):
    """The host loader's batch against the images before encoding, each
    resized by the plain formula: the error a libjpeg decode adds at
    quality 95 on the first 32 images of chip_smoke.py's set (shorter side
    256), which the card's nvJPEG batch is held to with a margin."""
    prefix = str(tmp_path / "err")
    mt.test_utils.write_image_rec(prefix, 32, seed=0, short=256)
    it = mt.image.ImageRecordIter(path_imgrec=prefix + ".rec",
                                  data_shape=(3, 224, 224), batch_size=32,
                                  ctx=mt.cpu())
    got = it.next().data[0].asnumpy()
    err = []
    for i in range(32):
        _, img = mt.test_utils.synthetic_image(0, i, 256)
        want = image_nvjpeg.resize_rgb_chw(torch.from_numpy(img), 224,
                                           224).numpy()
        err.append(np.abs(got[i] - want) * 255)
    err = np.stack(err)
    print("libjpeg decode vs the images (224 x 224, x 255): mean %.4f, "
          "rms %.4f, max %.4f" % (err.mean(), np.sqrt((err ** 2).mean()),
                                  err.max()))
    assert err.mean() < 5.0
