"""``image.detection`` of the PyTorch package against the JAX package on
the CPU, case for case with ``tests/test_image_detection.py`` (flip,
borrow, pad, crop, the ``CreateDetAugmenter`` pipeline): each augmenter
run in both packages from one ``random.seed`` gives the same boxes and
pixels (images within 1 of 255 where cv2's fixed-point resize is in the
JAX package's pipeline, else equal; boxes within 1e-6); and
``ImageDetIter`` over a ``.rec`` of detection records.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.image import detection as det


@pytest.fixture(autouse=True)
def _decode_on_the_cpu():
    """JPEG decodes on the current context, the card by default: these
    cases hold the ``cpu()`` route (libjpeg) to the JAX package."""
    with mt.cpu():
        yield


IMG = (np.random.RandomState(0).rand(40, 60, 3) * 255).astype(np.uint8)


def _label():
    # one object: class 0 box (0.25, 0.25)-(0.5, 0.75)
    return np.array([[0.0, 0.25, 0.25, 0.5, 0.75],
                     [-1.0, 0, 0, 0, 0]], np.float32)


def _both(make, seed, img=IMG, label_fn=_label):
    outs = []
    for pkg in (mt, mx):
        src = mt.nd.array(img, ctx=mt.cpu(), dtype=np.uint8) if pkg is mt \
            else pkg.nd.array(img, dtype=np.uint8)
        augs = make(pkg)
        random.seed(seed)
        np.random.seed(seed)
        x, lab = src, label_fn()
        for aug in augs:
            x, lab = aug(x, lab)
        outs.append((x.asnumpy() if hasattr(x, "asnumpy") else x, lab))
    return outs


def _assert_same(outs, atol=0.0):
    (a, la), (b, lb) = outs
    assert a.shape == b.shape
    np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                               atol=atol)
    np.testing.assert_allclose(la, lb, atol=1e-6)


def test_det_horizontal_flip_flips_boxes():
    outs = _both(lambda pkg: [pkg.image.detection.DetHorizontalFlipAug(p=1)],
                 0)
    _assert_same(outs)
    lab = outs[0][1]
    np.testing.assert_allclose(lab[0, [1, 3]], [0.5, 0.75], atol=1e-6)
    np.testing.assert_allclose(lab[0, [2, 4]], [0.25, 0.75], atol=1e-6)
    assert lab[1, 0] == -1.0
    np.testing.assert_array_equal(outs[0][0], IMG[:, ::-1])


def test_det_borrow_aug_passes_label():
    outs = _both(lambda pkg: [pkg.image.detection.DetBorrowAug(
        pkg.image.CastAug())], 0)
    _assert_same(outs)
    np.testing.assert_allclose(outs[0][1], _label())
    assert outs[0][0].dtype == np.float32
    with pytest.raises(TypeError):
        det.DetBorrowAug(lambda x: x)


def test_det_random_pad_shrinks_boxes():
    outs = _both(lambda pkg: [pkg.image.detection.DetRandomPadAug(
        area_range=(2.0, 2.0))], 0)
    _assert_same(outs)
    img, lab = outs[0]
    w_new = lab[0, 3] - lab[0, 1]
    assert w_new == pytest.approx(0.25 / np.sqrt(2), rel=0.1)
    assert 40 < img.shape[0] <= 57


@pytest.mark.parametrize("seed", [3, 4, 11])
def test_det_random_crop_keeps_object(seed):
    outs = _both(lambda pkg: [pkg.image.detection.DetRandomCropAug(
        min_object_covered=0.5, area_range=(0.5, 0.9), max_attempts=30)],
        seed)
    _assert_same(outs)
    lab = outs[0][1]
    valid = lab[lab[:, 0] >= 0]
    assert len(valid) >= 1
    assert (valid[:, 1:] >= 0).all() and (valid[:, 1:] <= 1).all()


@pytest.mark.parametrize("seed", [1, 2])
def test_create_det_augmenter_pipeline_runs(seed):
    pytest.importorskip("cv2")
    kw = dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True, mean=True,
              std=True, brightness=0.1, contrast=0.1, saturation=0.1)
    outs = _both(lambda pkg: pkg.image.detection.CreateDetAugmenter(
        (3, 32, 32), **kw), seed)
    # cv2 rounds its uint8 resize in fixed point: 1 of 255, normalized
    _assert_same(outs, atol=1.0 / 57.0 * 1.2)
    assert tuple(outs[0][0].shape) == (32, 32, 3)
    assert outs[0][1].shape[1] == 5


def test_image_det_iter(tmp_path):
    pytest.importorskip("cv2")
    rec = recordio.MXIndexedRecordIO(str(tmp_path / "d.idx"),
                                     str(tmp_path / "d.rec"), "w")
    n_obj = [1, 3, 2, 1, 2]
    for i, k in enumerate(n_obj):
        img = mt.test_utils.synthetic_image(0, i, 24)[1]
        boxes = [[j, 0.1 * j, 0.1, 0.1 * j + 0.3, 0.6] for j in range(k)]
        rec.write_idx(i, recordio.pack(
            recordio.IRHeader(0, np.array(boxes, np.float32).ravel(), i, 0),
            mt._native.jpeg_encode(img)))
    rec.close()
    outs = []
    for pkg in (mt, mx):
        random.seed(0)
        it = pkg.image.ImageDetIter(2, (3, 16, 16),
                                    path_imgrec=str(tmp_path / "d.rec"))
        outs.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad,
                      b.provide_label[0].shape) for b in it])
    assert len(outs[0]) == len(outs[1]) == 3
    for (da, la, pa, sa), (db, lb, pb, sb) in zip(*outs):
        assert pa == pb and tuple(sa) == tuple(sb)
        np.testing.assert_allclose(da, db, atol=1.0)
        np.testing.assert_allclose(la, lb, atol=1e-6)
    assert outs[0][0][1].shape == (2, 3, 5)
