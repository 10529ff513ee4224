"""The greedy-NMS kernels' decomposition (``test_utils.nms_tiled``, the
plain-PyTorch model of ``ops/csrc/nms.cu``) against both loops on the CPU.

- The model's mask for mask against ``nms.nms_reference`` (the loop the
  kernels are held to on the card) and the JAX package's ``ssd._nms_one``
  at the tile edges (n 1 to 200, trips that end mid-tile), class-aware and
  forced, and on tied scores, identical boxes, zero-area boxes (union 0),
  NaN and infinite corners, every box dead, classes that share the mask
  kernel's class bucket, a negative threshold and fp64.
- Each suppression word, bit by bit, against the loop's kill decision for
  that pair (bit r of word u is box 64u + r).
- ``Proposal``'s class-agnostic walk through the whole op with the model
  in place of the kernels, against the JAX package's.
- The wrapper's scratch arithmetic, and the walk's steps and the mask's
  pairs as ``chip_smoke.py`` reports them, against the model.
"""
import importlib.util
import itertools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.ops import ssd as jax_ssd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import nms as nm
from mxnet_tpu_torch.ops import rcnn
from mxnet_tpu_torch.test_utils import nms_class_buckets, nms_tiled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke_for_nms", "chip_smoke.py")

THRESHOLD = 0.45
EDGE_N = (1, 63, 64, 65, 127, 128, 129, 200)
EDGE_TRIPS = ("n", 77, 64, 128)
# classes that share a bucket of the mask kernel (c & 63) or fall in its
# bucket of the rest (fractional, 2**31 and beyond, NaN)
ODD_CLASSES = (0.0, -0.0, 64.0, 128.0, -64.0, 1.0, 65.0, 0.5, 2.0 ** 31,
               -2.0 ** 31, 1e10, np.nan, 3.0)


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


def _dets(rng, n, n_cls=4, dtype=np.float32, tie=False):
    """(n, 6) rows [class, score, box] sorted by score (stable); a tenth
    of the rows dead (class -1)."""
    xy = rng.uniform(0, 0.7, (n, 2))
    wh = rng.uniform(0.05, 0.4, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1)
    score = np.round(rng.rand(n), 1) if tie else rng.rand(n)
    cls = rng.randint(0, n_cls, n).astype(np.float64)
    cls[rng.rand(n) < 0.1] = -1.0
    dets = np.concatenate([cls[:, None], score[:, None], boxes], 1)
    return dets[np.argsort(-dets[:, 1], kind="stable")].astype(dtype)


def _edge_cases():
    seen = set()
    for n, trip in itertools.product(EDGE_N, EDGE_TRIPS):
        trip = n if trip == "n" else min(trip, n)
        if (n, trip) not in seen:
            seen.add((n, trip))
            yield n, trip


def _special(kind, rng, n):
    """Three images of ``n`` rows for one of the degenerate inputs."""
    tie = kind == "tied"
    dets = np.stack([_dets(rng, n, 3, np.float64, tie) for _ in range(3)])
    box = dets[..., 2:6]
    if kind == "identical":
        box[:] = box[:, :1]
    elif kind == "zero area":
        box[:, ::3, 2] = box[:, ::3, 0]            # zero width
        box[:, 1::5] = 0.25                         # points: union 0
    elif kind == "nan corners":
        box[:, ::4, rng.randint(0, 4)] = np.nan
        box[:, 2::7] = np.nan
    elif kind == "inf corners":
        box[:, ::5, 2] = np.inf
        box[:, 1::6, 1] = -np.inf
        box[:, 3::9, 2:] = np.inf
    elif kind == "all dead":
        dets[..., 0] = -1.0
    elif kind == "odd classes":   # one class bucket, several classes
        dets[..., 0] = rng.choice(ODD_CLASSES, dets.shape[:2])
    return dets


def _loops(dets, trip, force, threshold=THRESHOLD):
    """(the model's mask, nms_reference's, the JAX package's, words,
    the walk's steps)."""
    n = dets.shape[1]
    t = torch.tensor(dets)
    args = (t[..., 2:6], t[..., 0], t[..., 0] >= 0, trip, threshold, force)
    model, words, steps = nms_tiled(*args)
    ref = nm.nms_reference(*args)
    jax_mask = np.stack([np.asarray(jax_ssd._nms_one(
        jnp.asarray(d), threshold, force, trip if trip < n else -1))[:, 0]
        >= 0 for d in dets])
    return model.numpy(), ref.numpy(), jax_mask, words, steps


@pytest.mark.parametrize("force", [False, True], ids=["class-aware", "force"])
@pytest.mark.parametrize("n,trip", list(_edge_cases()),
                         ids=["n%d-trip%d" % c for c in _edge_cases()])
def test_tiled_model_at_tile_edges(n, trip, force):
    rng = np.random.RandomState(n * 1000 + trip)
    dets = np.stack([_dets(rng, n) for _ in range(3)])
    model, ref, jax_mask, words, steps = _loops(dets, trip, force)
    np.testing.assert_array_equal(model, ref)
    np.testing.assert_array_equal(model, jax_mask)
    assert tuple(words.shape) == nm.scratch_shape(3, n, trip)
    assert steps == cs.nms_tile_steps(n, trip)


@pytest.mark.parametrize("force", [False, True], ids=["class-aware", "force"])
@pytest.mark.parametrize("kind", ["tied", "identical", "zero area",
                                  "nan corners", "inf corners", "all dead",
                                  "odd classes"])
def test_tiled_model_degenerate_boxes(kind, force):
    rng = np.random.RandomState(len(kind))
    dets = _special(kind, rng, 129)
    for trip in (129, 100):
        model, ref, jax_mask, _, _ = _loops(dets, trip, force)
        np.testing.assert_array_equal(model, ref)
        np.testing.assert_array_equal(model, jax_mask)
    if kind == "identical":   # one survivor a class (one with force)
        kept = dets[..., 0][model]
        assert len(kept) == 3 * (1 if force else len(set(dets[0, :, 0])
                                                      - {-1.0}))
    if kind == "all dead":
        assert not model.any()


@pytest.mark.parametrize("threshold", [-0.1, 0.0, 1.0])
def test_tiled_model_threshold_edges(threshold):
    """At a negative threshold every pair of a class is a kill, the ones
    that do not overlap included (their IoU is 0); at 0 every overlap; at
    1 none."""
    rng = np.random.RandomState(5)
    dets = np.stack([_dets(rng, 130) for _ in range(2)])
    for force in (False, True):
        model, ref, jax_mask, _, _ = _loops(dets, 130, force, threshold)
        np.testing.assert_array_equal(model, ref)
        np.testing.assert_array_equal(model, jax_mask)


@pytest.mark.parametrize("kind", ["random", "zero area", "nan corners",
                                  "inf corners"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_words_are_the_loops_kill_decisions(kind, dtype):
    """Bit r of word (u, i) is the loop's decision for (i, 64u + r): the
    IoU over the threshold, the class, and j after i; the overlap filter
    changes no bit."""
    rng = np.random.RandomState(11)
    dets = _special(kind, rng, 150) if kind != "random" else np.stack(
        [_dets(rng, 150, 3, np.float64) for _ in range(3)])
    t = torch.tensor(dets, dtype=dtype)
    boxes, cls = t[..., 2:6], t[..., 0]
    for force, threshold in ((False, THRESHOLD), (True, 0.3), (False, -0.5)):
        trip = 140
        _, words, _ = nms_tiled(boxes, cls, cls >= 0, trip, threshold, force)
        n = boxes.shape[1]
        for i in range(trip):
            want = nm.iou_row(boxes[:, i:i + 1], boxes) > threshold
            if not force:
                want &= cls == cls[:, i:i + 1]
            want &= torch.arange(n) > i
            got = torch.stack([(words[:, j // nm.TILE, i] >> (j % nm.TILE))
                               & 1 for j in range(n)], 1).bool()
            assert torch.equal(got, want), (kind, force, i)


def test_tiled_model_fp64_and_trip_zero():
    rng = np.random.RandomState(2)
    dets = np.stack([_dets(rng, 70, 2, np.float64) for _ in range(2)])
    for trip in (70, 65, 1):
        model, ref, jax_mask, _, _ = _loops(dets, trip, False)
        np.testing.assert_array_equal(model, ref)
        np.testing.assert_array_equal(model, jax_mask)
    t = torch.tensor(dets)
    alive = t[..., 0] >= 0
    model, words, steps = nms_tiled(t[..., 2:6], t[..., 0], alive, 0, 0.45)
    assert torch.equal(model, alive) and words.numel() == 0 and steps == 1


@pytest.mark.parametrize("kind", ["ragged", "tied", "all suppressed"])
def test_tiled_model_in_proposal_against_jax(kind, monkeypatch):
    """Proposal's walk (``rcnn.py:91-99``) with the model in place of the
    kernels: 129 pre-NMS boxes an image (three tiles, the last one box;
    72 when all coincide)."""
    calls = []

    def model(*args, **kw):
        calls.append(args[3])
        return nms_tiled(*args, **kw)[0]

    monkeypatch.setattr(rcnn, "nms", model)
    rng = np.random.RandomState(4)
    n, a, h, w = 2, 6, 6, 12
    cls = rng.rand(n, 2 * a, h, w).astype(np.float32)
    bbox = (0.2 * rng.randn(n, 4 * a, h, w)).astype(np.float32)
    kw = dict(rpn_pre_nms_top_n=129, rpn_post_nms_top_n=40,
              feature_stride=16, scales=(4, 8), ratios=(0.5, 1, 2),
              threshold=0.6, rpn_min_size=4, output_score=True)
    if kind == "tied":
        cls = np.round(cls, 1)
    if kind == "all suppressed":
        cls[:] = 0.5
        bbox[:] = 0.0
        kw.update(scales=(64,), ratios=(1,), feature_stride=1,
                  threshold=0.01, rpn_post_nms_top_n=10)
        cls, bbox = cls[:, :2], bbox[:, :4]
    info = np.array([[96, 192, 1.0], [90, 180, 0.5]], np.float32)
    with mx.cpu():
        want = [o.asnumpy() for o in mx.nd.contrib.Proposal(
            mx.nd.array(cls), mx.nd.array(bbox), mx.nd.array(info), **kw)]
    with mt.cpu():
        got = [o.asnumpy() for o in mt.nd.contrib.Proposal(
            mt.nd.array(cls), mt.nd.array(bbox), mt.nd.array(info), **kw)]
    assert calls and calls[0] > nm.TILE
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g, wnt, rtol=1e-6, atol=1e-6)
    if kind == "all suppressed":
        assert ((got[1].reshape(n, -1) > 0).sum(axis=1) == 1).all()


def test_scratch_and_step_arithmetic():
    """The scratch at SSD-300 (32 x 8,732 anchors, ``nms_topk`` -1 and
    400) and Proposal (2 x 6,000), within 512 MB at SSD-300; the walk's
    steps as phase 31a reports them, against the model's at trip 0, mid
    tile and at n (n 129 with trip 128: a tile follows, one step more)."""
    assert nm.scratch_shape(32, 8732, 8732) == (32, 137, 8732)
    assert 8 * 32 * 137 * 8732 <= 512 * 2 ** 20
    assert nm.scratch_shape(32, 8732, 400) == (32, 137, 400)
    assert nm.scratch_shape(2, 6000, 6000) == (2, 94, 6000)
    assert cs.nms_tile_steps(8732, 8732) == 137
    assert cs.nms_tile_steps(8732, 400) == 8
    assert cs.nms_tile_steps(6000, 6000) == 94
    rng = np.random.RandomState(4)
    t = torch.tensor(np.stack([_dets(rng, 129) for _ in range(2)]))
    for trip in (0, 1, 63, 64, 65, 128, 129):
        args = (t[..., 2:6], t[..., 0], t[..., 0] >= 0, trip, THRESHOLD)
        assert nms_tiled(*args)[2] == cs.nms_tile_steps(129, trip)
        assert nms_tiled(*args)[1].shape == nm.scratch_shape(2, 129, trip)


def test_class_buckets():
    """``nms_class_buckets`` is ``nms.cu``'s class_key, value by value,
    in fp32 and fp64."""
    def key(c):
        if not -2.0 ** 31 < c < 2.0 ** 31 or c != int(c):
            return 64
        return int(c) & 63
    vals = ODD_CLASSES + (-1.0, 63.0, -65.0, 2.0 ** 31 - 1, 2.5, -0.5,
                          np.inf, -np.inf, 1e-30)
    for dtype in (torch.float32, torch.float64):
        c = torch.tensor(vals, dtype=dtype)
        want = [key(v) for v in c.double().tolist()]
        assert nms_class_buckets(c).tolist() == want


@pytest.mark.parametrize("force", [False, True], ids=["class-aware", "force"])
def test_mask_pairs_count(force):
    """Phase 31a's count of the pairs ``mask_kernel`` visits, against
    every pair (i < trip, j > i) counted one by one: all with force, else
    those of one class bucket or of a row in bucket 64."""
    rng = np.random.RandomState(9)
    cls = torch.tensor(rng.choice(ODD_CLASSES + (-1.0, 7.0), (3, 150)))
    for trip in (0, 1, 77, 150):
        key = nms_class_buckets(cls).tolist()
        want = 0
        for b in range(3):
            for i in range(trip):
                for j in range(i + 1, 150):
                    want += bool(force or key[b][i] == 64
                                 or key[b][i] == key[b][j])
        assert cs.nms_mask_pairs(cls, trip, force) == want


def test_wrapper_limits():
    """Past 360,448 boxes an image (its scratch some 16 GB) or 65,535
    images, the wrapper raises before it allocates or launches."""
    for batch, n in ((1, 360449), (65536, 1)):
        with pytest.raises(mt.MXNetError):
            nm._check_limits(batch, n)
    nm._check_limits(65535, 360448)


def test_wrapper_on_the_cpu_is_the_loop():
    rng = np.random.RandomState(8)
    t = torch.tensor(np.stack([_dets(rng, 65) for _ in range(2)]))
    args = (t[..., 2:6], t[..., 0], t[..., 0] >= 0, 65, THRESHOLD)
    before = nm.launch_count()
    assert torch.equal(nm.nms(*args), nm.nms_reference(*args))
    assert torch.equal(nm.nms(*args), nms_tiled(*args)[0])
    assert nm.launch_count() == before


def test_timing_tool_imports_no_jax():
    """``tools/torch_nms_timing.py`` (the kernels' times on the card)
    imports neither JAX nor the JAX package."""
    import ast
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "tools", "torch_nms_timing.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not {n.split(".")[0] for n in names} & {"jax", "jaxlib",
                                                   "mxnet_tpu"}
