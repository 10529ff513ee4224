"""The SSD ops and their greedy NMS against the JAX package on the CPU.

- ``tests/test_ssd_ops.py`` case for case: each case runs in both packages
  (``nd.contrib.MultiBoxPrior``/``MultiBoxTarget``/``MultiBoxDetection``),
  the reference's own assertions hold for the port, and the port's outputs
  equal the JAX package's within 1e-6 (the same fp32 formulas; the
  anchors' centres may round one ulp apart).
- NMS: the plain version (``ops.nms.nms_reference``, what the kernel is
  held to on the card) against the JAX package's ``ssd._nms_one`` on
  ragged sizes, tied scores, every box suppressed, ``force_suppress`` and
  a partial walk, mask for mask; and ``Proposal``'s class-agnostic walk
  against the JAX package's on tied, ragged and all-suppressed inputs.

``tests/test_torch_ssd_train.py`` has the toy SSD of BASELINE #5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.ops import ssd as jax_ssd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import nms as nm
from mxnet_tpu_torch.ops import ssd

PARITY = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    prev = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_enable_x64", prev[0])
    torch.set_num_threads(prev[1])


@pytest.fixture(autouse=True)
def own_names():
    with mx.name.NameManager(), mt.name.NameManager():
        yield


def both(fn):
    """``fn(pkg)`` in the JAX package and in this one (on the CPU), as
    numpy: (jax's, the port's)."""
    def host(out):
        if isinstance(out, (list, tuple)):
            return [o.asnumpy() for o in out]
        return out.asnumpy()
    with mx.cpu():
        want = host(fn(mx))
    with mt.cpu():
        got = host(fn(mt))
    return want, got


def assert_same(want, got, **tol):
    if isinstance(want, list):
        for w, g in zip(want, got):
            assert_same(w, g, **tol)
        return
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, **(tol or PARITY))


# -- tests/test_ssd_ops.py, case for case ------------------------------------
def test_multibox_prior_shapes_and_geometry():
    want, out = both(lambda p: p.nd.contrib.MultiBoxPrior(
        p.nd.zeros((1, 3, 2, 2)), sizes=(0.5, 0.25), ratios=(1.0, 2.0)))
    assert_same(want, out)
    assert out.shape == (1, 2 * 2 * 3, 4)
    boxes = out[0]
    np.testing.assert_allclose(boxes[0], [0.0, 0.0, 0.5, 0.5], atol=1e-6)
    np.testing.assert_allclose(boxes[1], [0.125, 0.125, 0.375, 0.375],
                               atol=1e-6)
    w, h = boxes[2][2] - boxes[2][0], boxes[2][3] - boxes[2][1]
    np.testing.assert_allclose(w / h, 2.0, rtol=1e-5)


def test_multibox_prior_clip():
    want, out = both(lambda p: p.nd.contrib.MultiBoxPrior(
        p.nd.zeros((1, 3, 1, 1)), sizes=(1.5,), clip=True))
    assert_same(want, out)
    assert out.min() >= 0.0 and out.max() <= 1.0


def _toy_setup(p):
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9],
                         [0.0, 0.0, 0.05, 0.05]]], np.float32)
    label = np.array([[[0.0, 0.1, 0.1, 0.45, 0.5],
                       [-1.0, 0.0, 0.0, 0.0, 0.0]]], np.float32)
    cls_pred = np.zeros((1, 3, 3), np.float32)
    return p.nd.array(anchors), p.nd.array(label), p.nd.array(cls_pred)


def test_multibox_target_matching():
    want, got = both(lambda p: p.nd.contrib.MultiBoxTarget(
        *_toy_setup(p), overlap_threshold=0.5))
    assert_same(want, got)
    cls_np = got[2][0]
    assert cls_np[0] == 1.0 and cls_np[1] == 0.0 and cls_np[2] == 0.0
    mask = got[1][0].reshape(3, 4)
    assert mask[0].sum() == 4 and mask[1].sum() == 0


def test_multibox_target_encode_decode_roundtrip():
    anchors = np.array([[0.1, 0.1, 0.5, 0.5], [0.2, 0.3, 0.8, 0.9]],
                       np.float32)
    gt = np.array([[0.15, 0.12, 0.55, 0.48], [0.25, 0.35, 0.75, 0.85]],
                  np.float32)
    var = (0.1, 0.1, 0.2, 0.2)
    enc = ssd.encode_offsets(torch.tensor(anchors), torch.tensor(gt), var)
    dec = ssd.decode_offsets(torch.tensor(anchors), enc, var)
    np.testing.assert_allclose(dec.numpy(), gt, atol=1e-5)
    want = jax_ssd._encode_offsets(jnp.asarray(anchors), jnp.asarray(gt), var)
    np.testing.assert_allclose(enc.numpy(), np.asarray(want), **PARITY)
    np.testing.assert_allclose(
        dec.numpy(), np.asarray(jax_ssd._decode_offsets(
            jnp.asarray(anchors), want, var)), **PARITY)


def test_multibox_detection_end_to_end():
    probs = np.array([[[0.05, 0.9, 0.9], [0.9, 0.05, 0.05],
                       [0.05, 0.05, 0.05]]], np.float32)

    def run(p):
        anchor, _, _ = _toy_setup(p)
        return p.nd.contrib.MultiBoxDetection(
            p.nd.array(probs), p.nd.zeros((1, 12)), anchor, threshold=0.1,
            nms_threshold=0.5)
    want, out = both(run)
    assert_same(want, out)
    valid = out[0][out[0][:, 0] >= 0]
    assert valid.shape[0] == 1
    np.testing.assert_allclose(valid[0, :2], [0.0, 0.9], atol=1e-5)
    np.testing.assert_allclose(valid[0, 2:], [0.1, 0.1, 0.5, 0.5], atol=1e-5)


def test_multibox_detection_nms_suppression():
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5], [0.12, 0.12, 0.52, 0.52]]],
                       np.float32)
    probs = np.array([[[0.1, 0.2], [0.9, 0.8]]], np.float32)
    want, out = both(lambda p: p.nd.contrib.MultiBoxDetection(
        p.nd.array(probs), p.nd.zeros((1, 8)), p.nd.array(anchors),
        threshold=0.1, nms_threshold=0.5))
    assert_same(want, out)
    valid = out[0][out[0][:, 0] >= 0]
    assert valid.shape[0] == 1 and abs(valid[0, 1] - 0.9) < 1e-5


def test_multibox_prior_steps_offsets_are_y_then_x():
    want, out = both(lambda p: p.nd.contrib.MultiBoxPrior(
        p.nd.zeros((1, 3, 2, 4)), sizes=(0.2,), steps=(0.5, 0.25),
        offsets=(0.0, 0.5)))
    assert_same(want, out)
    cy = (out[0, 0, 1] + out[0, 0, 3]) / 2
    cx = (out[0, 0, 0] + out[0, 0, 2]) / 2
    assert abs(cy - 0.0) < 1e-6 and abs(cx - 0.125) < 1e-6


def test_sym_contrib_and_shape_inference():
    """``sym.contrib`` holds the ops; a Symbol of the three infers its
    shapes from the inputs' (on meta tensors, NMS included)."""
    S = mt.sym
    data = S.Variable("data")
    anchors = S.contrib.MultiBoxPrior(data, sizes=(0.3, 0.5),
                                      ratios=(1.0, 2.0))
    tgt = S.contrib.MultiBoxTarget(anchors, S.Variable("label"),
                                   S.Variable("cls_pred"))
    det = S.contrib.MultiBoxDetection(S.Variable("cls_prob"),
                                      S.Variable("loc_pred"), anchors)
    _, outs, _ = S.Group([tgt, det]).infer_shape(
        data=(2, 3, 4, 4), label=(2, 5, 5), cls_pred=(2, 4, 48),
        cls_prob=(2, 4, 48), loc_pred=(2, 192))
    assert [tuple(o) for o in outs] == [(2, 192), (2, 192), (2, 48),
                                        (2, 48, 6)]


# -- NMS: the plain version against the JAX loops ------------------------------
def _dets(rng, n, n_cls, tie=False, same=False):
    """(n, 6) rows [class, score, box] sorted by score (stable)."""
    xy = rng.uniform(0, 0.7, (n, 2))
    wh = rng.uniform(0.05, 0.4, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1)
    if same:
        boxes[:] = boxes[0]
    score = np.round(rng.rand(n), 1) if tie else rng.rand(n)
    cls = rng.randint(0, n_cls, n).astype(np.float64)
    cls[rng.rand(n) < 0.1] = -1.0
    dets = np.concatenate([cls[:, None], score[:, None], boxes], 1)
    return dets[np.argsort(-dets[:, 1], kind="stable")].astype(np.float32)


@pytest.mark.parametrize("n,n_cls,tie,same,force,topk", [
    (1, 1, False, False, False, -1), (2, 1, False, True, False, -1),
    (37, 3, False, False, False, -1), (37, 3, True, False, True, -1),
    (64, 2, True, False, False, 10), (50, 1, False, True, True, -1),
    (129, 4, False, False, False, 77)],
    ids=["one", "two identical", "ragged 37", "tied forced", "tied topk",
         "all suppressed", "ragged topk"])
def test_nms_plain_version_against_jax(n, n_cls, tie, same, force, topk):
    rng = np.random.RandomState(n + 7 * n_cls)
    dets = np.stack([_dets(rng, n, n_cls, tie, same) for _ in range(3)])
    trip = ssd.nms_trip(topk, n)
    t = torch.tensor(dets)
    alive = nm.nms_reference(t[..., 2:6], t[..., 0], t[..., 0] >= 0, trip,
                             0.45, force)
    want = np.stack([np.asarray(jax_ssd._nms_one(
        jnp.asarray(d), 0.45, force, topk if topk > 0 else n))[:, 0] >= 0
        for d in dets])
    np.testing.assert_array_equal(alive.numpy(), want)
    assert nm.nms(t[..., 2:6], t[..., 0], t[..., 0] >= 0, trip, 0.45,
                  force).equal(alive)
    if same:   # identical boxes: one survivor a class (one with force)
        kept = dets[..., 0][alive.numpy()]
        assert len(kept) == 3 * (1 if force else
                                 len(set(dets[0, :, 0]) - {-1.0}))


@pytest.mark.parametrize("kind", ["tied", "ragged", "all suppressed"])
def test_proposal_walk_against_jax(kind):
    """Proposal's class-agnostic walk (``rcnn.py:91-99``) through the whole
    op: tied scores keep index order, a pre-NMS count that is no multiple
    of anything, and anchors that all coincide (one survivor an image)."""
    rng = np.random.RandomState(3)
    n, a, h, w = 2, 3, 5, 4
    cls = rng.rand(n, 2 * a, h, w).astype(np.float32)
    bbox = (0.2 * rng.randn(n, 4 * a, h, w)).astype(np.float32)
    kw = dict(rpn_pre_nms_top_n=37, rpn_post_nms_top_n=20,
              feature_stride=16, scales=(8,), ratios=(0.5, 1, 2),
              threshold=0.6, rpn_min_size=4, output_score=True)
    if kind == "tied":
        cls = np.round(cls, 1)
    if kind == "all suppressed":
        cls[:] = 0.5
        bbox[:] = 0.0
        kw.update(scales=(64,), ratios=(1,), feature_stride=1,
                  threshold=0.01)
        cls, bbox = cls[:, :2], bbox[:, :4]
    info = np.array([[80, 64, 1.0], [70, 60, 0.5]], np.float32)
    want, got = both(lambda p: p.nd.contrib.Proposal(
        p.nd.array(cls), p.nd.array(bbox), p.nd.array(info), **kw))
    assert_same(want, got)
    if kind == "all suppressed":
        alive = got[1].reshape(n, -1) > 0
        assert alive.sum(axis=1).tolist() == [1, 1]
