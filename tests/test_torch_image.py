"""``image`` of the PyTorch package against the JAX package on the CPU.

- ``imdecode`` (libjpeg) against the JAX package's (cv2, where it is
  installed) bit for bit, color, grayscale and BGR; a corrupt buffer
  raises.
- The resizes against the JAX package's cv2 calls: nearest equal, the
  other interpolations within 1 of 255 for uint8 (cv2's fixed-point
  weights and its own rounding of ties), float images within 1e-4.
  Without cv2 they are held to numpy formulas written here: bilinear at
  half-pixel centres, nearest by floor, area as the box mean.
- Every augmenter and the crops, under one ``random.seed`` (and
  ``np.random.seed`` for ``LightingAug``), equal to the JAX package's
  within 1e-5 (float32 arithmetic in the same order; the bilinear crops
  within 1 of 255 as above), and ``CreateAugmenter``'s lists alike.
- ``ImageIter`` over a ``.rec`` (sequential and shuffled through its
  ``.idx``), a ``.lst`` and an in-memory list: shapes, labels, order.
"""
import random

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


IMG = np.random.RandomState(0).randint(0, 256, (40, 60, 3)).astype(np.uint8)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _jpeg(img=None, quality=95):
    if img is None:
        img = mt.test_utils.synthetic_image(0, 5, 48)[1]
    return mt._native.jpeg_encode(img, quality)


def test_imdecode_matches_jax():
    pytest.importorskip("cv2")
    buf = _jpeg()
    for kw in ({}, {"flag": 0}, {"to_rgb": False}):
        a, b = mt.image.imdecode(buf, **kw), mx.image.imdecode(buf, **kw)
        assert a.dtype == np.uint8 and a.context == mt.cpu()
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_imdecode_png_and_errors():
    pytest.importorskip("PIL")
    import io
    from PIL import Image
    bio = io.BytesIO()
    Image.fromarray(IMG).save(bio, format="PNG")
    np.testing.assert_array_equal(mt.image.imdecode(bio.getvalue())
                                  .asnumpy(), IMG)
    with pytest.raises(MXNetError, match="Decoding image failed"):
        mt.image.imdecode(b"\xff\xd8\xff garbage")
    with pytest.raises(MXNetError, match="Decoding image failed"):
        mt.image.imdecode(b"not an image at all")


def test_other_formats_without_pil_raise_naming_them(monkeypatch):
    monkeypatch.setattr(recordio, "_pil", lambda: None)
    for head, name in ((b"\x89PNG\r\n", "PNG"), (b"GIF89a", "GIF"),
                       (b"BM\x00\x00", "BMP"), (b"????", "unknown")):
        with pytest.raises(MXNetError, match="decoding a %s image needs PIL"
                           % name):
            mt.image.imdecode(head + b"\x00" * 16)
    with pytest.raises(MXNetError, match=".png needs PIL"):
        recordio.pack_img(recordio.IRHeader(0, 1.0, 0, 0), IMG, img_fmt=".png")
    # JPEG needs only libjpeg
    assert mt.image.imdecode(_jpeg()).shape[2] == 3


SIZES = [(10, 7), (60, 40), (90, 61), (13, 29), (45, 11)]


@pytest.mark.parametrize("interp", [0, 1, 2, 3])
@pytest.mark.parametrize("size", SIZES)
def test_imresize_matches_cv2(interp, size):
    pytest.importorskip("cv2")
    w, h = size
    a = mt.image.imresize(IMG, w, h, interp).asnumpy()
    b = mx.image.imresize(IMG, w, h, interp).asnumpy()
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    assert np.abs(a.astype(int) - b).max() <= (0 if interp == 0 else 1)
    f = IMG.astype(np.float32)
    np.testing.assert_allclose(mt.image.imresize(f, w, h, interp).asnumpy(),
                               mx.image.imresize(f, w, h, interp).asnumpy(),
                               atol=1e-4)


def _bilinear(img, w, h):
    sh, sw = img.shape[:2]
    out = np.zeros((h, w, img.shape[2]))
    for y in range(h):
        fy = min(max((y + 0.5) * sh / h - 0.5, 0), sh - 1)
        y0 = int(np.floor(fy))
        y1 = min(y0 + 1, sh - 1)
        for x in range(w):
            fx = min(max((x + 0.5) * sw / w - 0.5, 0), sw - 1)
            x0 = int(np.floor(fx))
            x1 = min(x0 + 1, sw - 1)
            ay, ax = fy - y0, fx - x0
            out[y, x] = ((1 - ay) * ((1 - ax) * img[y0, x0] + ax * img[y0, x1])
                         + ay * ((1 - ax) * img[y1, x0] + ax * img[y1, x1]))
    return out


@pytest.mark.parametrize("size", SIZES)
def test_imresize_numpy_formulas(size):
    w, h = size
    f = IMG.astype(np.float32)
    np.testing.assert_allclose(mt.image.imresize(f, w, h, 1).asnumpy(),
                               _bilinear(f, w, h), atol=1e-3)
    ys = np.minimum(np.floor(np.arange(h) * 40 / h).astype(int), 39)
    xs = np.minimum(np.floor(np.arange(w) * 60 / w).astype(int), 59)
    np.testing.assert_array_equal(mt.image.imresize(IMG, w, h, 0).asnumpy(),
                                  IMG[ys][:, xs])
    # area at an integer factor: the mean of each 2 x 3 box
    box = f.reshape(20, 2, 20, 3, 3).mean(axis=(1, 3))
    np.testing.assert_allclose(mt.image.imresize(f, 20, 20, 3).asnumpy(),
                               box, atol=1e-4)


def test_resize_weights_rows_sum_to_one():
    for interp in (0, 1, 2, 3):
        for src, dst in ((40, 13), (13, 40), (7, 7)):
            w = mt.image.resize_weights(src, dst, interp, dst > src)
            np.testing.assert_allclose(w.sum(1), 1.0, atol=1e-12)
    with pytest.raises(MXNetError, match="interpolation"):
        mt.image.resize_weights(4, 2, 7)


def _same(a, b, atol=1e-5):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                               atol=atol)


def _seeded(fn, seed):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def _run_both(make, seed, src=IMG, atol=1e-5):
    """The augmenter ``make(pkg)`` on both packages' copies of ``src``
    from one seed, three draws each."""
    outs = []
    for pkg in (mt, mx):
        aug = make(pkg)
        img = pkg.nd.array(src, dtype=src.dtype) if pkg is mx else \
            mt.nd.array(src, ctx=mt.cpu(), dtype=src.dtype)
        outs.append(_seeded(lambda: [aug(img)[0] for _ in range(3)], seed))
    for a, b in zip(*outs):
        _same(a, b, atol)


AUGS = {
    "brightness": lambda pkg: pkg.image.BrightnessJitterAug(0.3),
    "contrast": lambda pkg: pkg.image.ContrastJitterAug(0.3),
    "saturation": lambda pkg: pkg.image.SaturationJitterAug(0.3),
    "hue": lambda pkg: pkg.image.HueJitterAug(0.2),
    "color_jitter": lambda pkg: pkg.image.ColorJitterAug(0.2, 0.3, 0.4),
    "lighting": lambda pkg: pkg.image.LightingAug(
        0.1, [55.46, 4.794, 1.148], [[-0.5675, 0.7192, 0.4009],
                                     [-0.5808, -0.0045, -0.8140],
                                     [-0.5836, -0.6948, 0.4203]]),
    "normalize": lambda pkg: pkg.image.ColorNormalizeAug(
        np.array([123.68, 116.28, 103.53]), np.array([58.4, 57.1, 57.4])),
    "flip": lambda pkg: pkg.image.HorizontalFlipAug(0.5),
    "cast": lambda pkg: pkg.image.CastAug(),
    "random_crop": lambda pkg: pkg.image.RandomCropAug((24, 16)),
    "center_crop": lambda pkg: pkg.image.CenterCropAug((30, 20)),
    "random_order": lambda pkg: pkg.image.RandomOrderAug(
        [pkg.image.BrightnessJitterAug(0.1), pkg.image.HorizontalFlipAug(1),
         pkg.image.CastAug()]),
}


@pytest.mark.parametrize("name", sorted(AUGS))
@pytest.mark.parametrize("seed", [0, 7])
def test_augmenters_match_jax(name, seed):
    src = IMG.astype(np.float32) if name in ("hue", "lighting") else IMG
    _run_both(AUGS[name], seed, src)


@pytest.mark.parametrize("name", ["resize", "force_resize", "sized_crop",
                                  "crop_resize"])
def test_resizing_augmenters_match_jax(name):
    pytest.importorskip("cv2")
    make = {
        "resize": lambda pkg: pkg.image.ResizeAug(32, 1),
        "force_resize": lambda pkg: pkg.image.ForceResizeAug((50, 30), 2),
        "sized_crop": lambda pkg: pkg.image.RandomSizedCropAug(
            (24, 24), 0.3, (0.75, 1.33), 1),
        "crop_resize": lambda pkg: pkg.image.CenterCropAug((80, 50), 0),
    }[name]
    _run_both(make, 3, atol=1.0)


def test_crop_functions_match_jax():
    for pkg_fns in ("fixed", "random", "center", "sized"):
        outs = []
        for pkg in (mt, mx):
            src = pkg.nd.array(IMG, dtype=np.uint8) if pkg is mx else \
                mt.nd.array(IMG, ctx=mt.cpu(), dtype=np.uint8)
            im = pkg.image
            fn = {"fixed": lambda: (im.fixed_crop(src, 3, 5, 20, 10), None),
                  "random": lambda: im.random_crop(src, (20, 12)),
                  "center": lambda: im.center_crop(src, (22, 14)),
                  "sized": lambda: im.random_size_crop(
                      src, (16, 16), 0.5, (0.75, 1.33), 0)}[pkg_fns]
            outs.append(_seeded(fn, 5))
        (a, abox), (b, bbox) = outs
        _same(a, b, 0)
        assert abox == bbox
    assert mt.image.scale_down((30, 20), (60, 50)) == \
        mx.image.scale_down((30, 20), (60, 50))
    np.testing.assert_allclose(
        mt.image.color_normalize(IMG.astype(np.float32), 5.0, 2.0),
        (IMG.astype(np.float32) - 5.0) / 2.0)


@pytest.mark.parametrize("kw", [
    {}, {"rand_crop": True, "rand_mirror": True},
    {"resize": 50, "rand_crop": True, "rand_resize": True, "mean": True,
     "std": True, "brightness": 0.1, "contrast": 0.1, "saturation": 0.1,
     "pca_noise": 0.1}])
def test_create_augmenter_matches_jax(kw):
    pytest.importorskip("cv2")
    a = mt.image.CreateAugmenter((3, 24, 24), **kw)
    b = mx.image.CreateAugmenter((3, 24, 24), **kw)
    assert [x.dumps()[0] for x in a] == [x.dumps()[0] for x in b]
    outs = []
    for pkg, augs in ((mt, a), (mx, b)):
        img = pkg.nd.array(IMG, dtype=np.uint8) if pkg is mx else \
            mt.nd.array(IMG, ctx=mt.cpu(), dtype=np.uint8)

        def run():
            x = img
            for aug in augs:
                x = aug(x)[0]
            return x
        outs.append(_seeded(run, 2))
    assert _np(outs[0]).shape == (24, 24, 3)
    _same(outs[0], outs[1], atol=1.0)
    with pytest.raises(ValueError):
        mt.image.CreateAugmenter((3, 8, 8), rand_resize=True)


def _write_images(tmp_path, n=6):
    """n JPEG files, a .lst naming them and a .rec/.idx holding them."""
    lst = []
    rec = recordio.MXIndexedRecordIO(str(tmp_path / "d.idx"),
                                     str(tmp_path / "d.rec"), "w")
    for i in range(n):
        label, img = mt.test_utils.synthetic_image(2, i, 20, classes=5)
        buf = _jpeg(img)
        (tmp_path / ("f%d.jpg" % i)).write_bytes(buf)
        lst.append("%d\t%d\tf%d.jpg\n" % (i, label, i))
        rec.write_idx(i, recordio.pack(recordio.IRHeader(0, label, i, 0),
                                       buf))
    rec.close()
    (tmp_path / "d.lst").write_text("".join(lst))
    return [mt.test_utils.synthetic_image(2, i, 20, classes=5)[0]
            for i in range(n)]


def _iter_both(tmp_path, seed=0, **kw):
    outs = []
    for pkg in (mt, mx):
        random.seed(seed)
        it = pkg.image.ImageIter(4, (3, 16, 16), **kw)
        outs.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                     for b in it])
    return outs


@pytest.mark.parametrize("source", ["rec", "rec_shuffled", "lst", "list"])
def test_image_iter_matches_jax(tmp_path, source):
    pytest.importorskip("cv2")
    labels = _write_images(tmp_path)
    kw = {"rec": dict(path_imgrec=str(tmp_path / "d.rec")),
          "rec_shuffled": dict(path_imgrec=str(tmp_path / "d.rec"),
                               path_imgidx=str(tmp_path / "d.idx"),
                               shuffle=True),
          "lst": dict(path_imglist=str(tmp_path / "d.lst"),
                      path_root=str(tmp_path)),
          "list": dict(imglist=[[labels[i], "f%d.jpg" % i]
                                for i in range(6)],
                       path_root=str(tmp_path))}[source]
    a, b = _iter_both(tmp_path, seed=4, **kw)
    assert len(a) == len(b) == 2 and a[1][2] == b[1][2] == 2
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert da.shape == (4, 3, 16, 16) and da.dtype == np.float32
        np.testing.assert_allclose(da, db, atol=1.0)
        np.testing.assert_array_equal(la, lb)
    got = np.concatenate([la[:4 - pa] for _, la, pa in a])
    if source in ("rec", "lst", "list"):
        np.testing.assert_array_equal(got, labels)
    else:
        assert sorted(got) == sorted(labels) and list(got) != labels


def test_image_iter_needs_a_source():
    with pytest.raises(ValueError):
        mt.image.ImageIter(2, (3, 8, 8))
