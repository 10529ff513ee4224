"""The resize kernel's round (``ops.image_nvjpeg.resize_rgb_chw_batch``)
on the CPU: its plain version against a loop of the one-image plain
version and numpy's ``-=`` / ``*=`` (ragged sizes, 1 to 4 channels, mixed
mirrors, means of length 1 and c, a scale, holes for failed records), the
table the kernel reads (the slot map and the blank tail), the mean's
broadcast raising where numpy's does, and, from the pixels libjpeg
decodes, the JAX package's ``ImageRecordIter`` batches (mean, scale, a
corrupt record, a short last batch) bit for bit.  The kernel itself is
held to the plain version on the card by ``chip_smoke.py`` phase 26.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, profiler, recordio
from mxnet_tpu_torch.ops import image_nvjpeg as nj

PIL = pytest.importorskip("PIL")

SIZES = [(1, 1), (37, 50), (50, 37), (24, 40)]   # (h, w): upright, landscape
IMAGENET_MEAN = (123.68, 116.779, 103.939)


def _sources(seed, holes=()):
    """One uint8 RGB image of each of SIZES, None at ``holes``."""
    rng = np.random.default_rng(seed)
    srcs = [torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8))
            for h, w in SIZES]
    for i in holes:
        srcs.insert(i, None)
    return srcs


def _numpy_round(srcs, dh, dw, c, mirrors, mean, scale):
    """The loop of the one-image plain version into the compacted slots,
    then the iterator's numpy arithmetic on the whole batch."""
    out = np.zeros((len(srcs), c, dh, dw), np.float32)
    k = 0
    for src, flip in zip(srcs, mirrors):
        if src is not None:
            out[k] = nj.resize_rgb_chw_reference(src, dh, dw, c, flip).numpy()
            k += 1
    if mean is not None:
        out -= np.asarray(mean, np.float32).reshape(1, -1, 1, 1)
    if scale is not None:
        out *= np.float32(scale)
    return out


def _mean(kind, c):
    if kind is None:
        return None
    if kind == "one":
        return np.float32([0.45])
    return (np.float32(IMAGENET_MEAN * 2)[:c] / 255.0).astype(np.float32)


@pytest.mark.parametrize("holes", [(), (1, 4), (0, 5, 6)])
@pytest.mark.parametrize("scale", [None, 0.0171])
@pytest.mark.parametrize("mean", [None, "one", "per_channel"])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_batch_reference_is_the_loop_and_numpy(c, mean, scale, holes):
    srcs = _sources(c, holes)
    mirrors = [i % 3 == 1 for i in range(len(srcs))]
    m = _mean(mean, c)
    for dh, dw in [(24, 20), (7, 9)]:
        got = nj.resize_rgb_chw_batch_reference(srcs, dh, dw, c, mirrors,
                                                m, scale)
        want = _numpy_round(srcs, dh, dw, c, mirrors, m, scale)
        assert got.dtype == torch.float32
        assert got.shape == (len(srcs), c, dh, dw)
        np.testing.assert_array_equal(got.numpy(), want)


def test_round_slots_compact_failures():
    assert nj.round_slots([True, False, True, True, False]) == \
        [0, None, 1, 2, None]
    assert nj.round_slots([False, True, True]) == [None, 0, 1]
    assert nj.round_slots([]) == []


def test_round_table_rows():
    """Decoded images to the front in order, each with its fp32 scale
    factors, size, flag and slot; a blank row (address 0) for each slot
    past them; the layout the kernel's ``Desc`` has."""
    assert nj.DESC.itemsize == 32
    srcs = _sources(0, holes=(1, 3))
    mirrors = [True, False, False, True, True, False]
    table = nj.round_table(srcs, 24, 20, mirrors)
    decoded = [(s, f) for s, f in zip(srcs, mirrors) if s is not None]
    assert table["slot"].tolist() == list(range(len(srcs)))
    for row, (src, flip) in zip(table, decoded):
        sh, sw = src.shape[:2]
        assert row["src"] == src.data_ptr()
        assert (row["sw"], row["sh"], bool(row["flip"])) == (sw, sh, flip)
        assert row["sx"] == np.float32(sw) / np.float32(20)
        assert row["sy"] == np.float32(sh) / np.float32(24)
    assert table["src"][len(decoded):].tolist() == [0, 0]
    with pytest.raises(MXNetError, match="mirror flags"):
        nj.round_table(srcs, 24, 20, [True])


@pytest.mark.parametrize("mean, c", [((1.0, 2.0), 3), ((1.0, 2.0, 3.0), 1),
                                     ((1.0, 2.0, 3.0), 4)])
def test_mean_numpy_cannot_broadcast_raises(mean, c):
    batch = np.zeros((2, c, 3, 3), np.float32)
    with pytest.raises(ValueError):
        batch -= np.asarray(mean, np.float32).reshape(1, -1, 1, 1)
    with pytest.raises(ValueError):
        nj.channel_mean(mean, c)
    with pytest.raises(ValueError):
        nj.resize_rgb_chw_batch_reference(_sources(1), 4, 4, c, mean=mean)


@pytest.mark.parametrize("mean, c, want", [
    (0.5, 3, [0.5, 0.5, 0.5]), ([[0.1, 0.2, 0.3]], 3, [0.1, 0.2, 0.3]),
    ((0.25,), 4, [0.25] * 4)])
def test_channel_mean_broadcasts_as_numpy(mean, c, want):
    got = nj.channel_mean(mean, c)
    assert got.dtype == np.float32 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, np.float32(want))


def test_cpu_route_is_the_plain_version(monkeypatch):
    """CPU tensors never reach the kernel's library: the round and the
    one-image call are the plain versions, and count no launch."""
    def no_kernel():
        raise AssertionError("the CPU route loaded the kernel")
    monkeypatch.setattr(nj, "loader_lib", no_kernel)
    srcs = _sources(2, holes=(2,))
    mirrors = [True] * len(srcs)
    m = _mean("per_channel", 3)
    before = profiler.counter(nj.COUNTER)
    got = nj.resize_rgb_chw_batch(srcs, 16, 12, 3, mirrors, m, 0.5)
    want = nj.resize_rgb_chw_batch_reference(srcs, 16, 12, 3, mirrors, m,
                                             0.5)
    assert torch.equal(got, want)
    one = nj.resize_rgb_chw(srcs[1], 16, 12, 3, True)
    assert torch.equal(one, nj.resize_rgb_chw_reference(srcs[1], 16, 12, 3,
                                                        True))
    plain = nj.resize_rgb_chw_batch(srcs, 16, 12, 3, mirrors)
    assert torch.equal(one, plain[1])
    assert profiler.counter(nj.COUNTER) == before


def test_card_request_without_a_card_raises(tmp_path):
    """The card route with a mean and a scale needs the card: without one
    it raises rather than decoding on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    prefix = str(tmp_path / "c")
    mt.test_utils.write_image_rec(prefix, 2, seed=0, short=16)
    for ctx in (lambda: mt.gpu(0), lambda: "cuda"):
        with pytest.raises(MXNetError, match="CUDA device"):
            mt.image.ImageRecordIter(path_imgrec=prefix + ".rec",
                                     data_shape=(3, 8, 8), batch_size=2,
                                     mean_rgb=IMAGENET_MEAN, scale=0.5,
                                     ctx=ctx())


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _libjpeg_pixels(path, n):
    rec = recordio.MXRecordIO(path + ".rec", "r")
    out = []
    for _ in range(n):
        _, jpg = recordio.unpack(rec.read())
        try:
            out.append(torch.from_numpy(mt._native.jpeg_decode(jpg, 1)))
        except Exception:   # the corrupt payloads
            out.append(None)
    rec.close()
    return out


@pytest.mark.parametrize("shape", [(3, 24, 20), (4, 7, 9), (1, 16, 16)])
def test_batched_plain_version_is_the_jax_loaders_batch(tmp_path, shape):
    """From libjpeg's pixels, the batched plain version with ``mean_rgb``
    and ``scale`` gives the JAX package's ``ImageRecordIter`` batches bit
    for bit, a corrupt record compacted out and the short last batch's
    tail (zeros less the mean, times the scale) included; the port's CPU
    route gives the same."""
    c, h, w = shape
    path = str(tmp_path / "m")
    n, batch, corrupt = 11, 4, {2, 8}
    mt.test_utils.write_image_rec(path, n, seed=5, short=30, classes=10,
                                  corrupt=corrupt)
    pixels = _libjpeg_pixels(path, n)
    assert [p is None for p in pixels] == [i in corrupt for i in range(n)]
    mean_rgb = IMAGENET_MEAN if c == 3 else (120.0,)
    kw = dict(path_imgrec=path + ".rec", data_shape=shape,
              batch_size=batch, mean_rgb=mean_rgb, scale=1 / 58.0,
              allow_corrupt=True, preprocess_threads=2)
    ref = mx.image.ImageRecordIter(**kw)
    port = mt.image.ImageRecordIter(ctx=mt.cpu(), **kw)
    mean = np.asarray(mean_rgb, np.float32) / 255.0
    # the loader's batches are its rounds: records 0-3 (2 failed) topped up
    # by 4; 5-8 (8 failed) by 9; then 10 alone, the tail blank
    batches = [(range(0, 5), 0), (range(5, 10), 0), (range(10, 11), 3)]
    for records, pad in batches:
        srcs = [pixels[i] for i in records] + [None] * pad
        want = nj.resize_rgb_chw_batch_reference(srcs, h, w, c, None, mean,
                                                 1 / 58.0)[:batch].numpy()
        labels = [mt.test_utils.synthetic_image(5, i, 30, 10)[0]
                  for i in records if i not in corrupt]
        for it in (ref, port):
            b = it.next()
            assert b.pad == pad
            np.testing.assert_array_equal(b.data[0].asnumpy(), want)
            np.testing.assert_array_equal(b.label[0].asnumpy()[:batch - pad],
                                          np.float32(labels))
    for it in (ref, port):
        with pytest.raises(StopIteration):
            it.next()
        assert it.num_failed == len(corrupt)


def test_loader_batches_is_the_loaders_order(tmp_path):
    """``test_utils.loader_batches`` (what ``chip_smoke.py`` holds the
    card's ``allow_corrupt`` batches to) is the order, labels, ``pad`` and
    ``num_failed`` of the JAX package's loader and of the port's CPU
    route, at chip_smoke.py's pattern of corrupt records: holes in a
    round, a top-up round, a short last batch."""
    cs = _chip_smoke()
    n, batch = cs.CORRUPT_IMAGES, cs.DATA_BATCH
    corrupt = cs.CORRUPT_RECORDS
    path = str(tmp_path / "k")
    mt.test_utils.write_image_rec(path, n, seed=2, short=12, classes=50,
                                  corrupt=corrupt)
    want = mt.test_utils.loader_batches(n, batch, corrupt)
    assert [pad for _, pad in want][-1] > 0
    kw = dict(path_imgrec=path + ".rec", data_shape=(3, 8, 8),
              batch_size=batch, allow_corrupt=True, preprocess_threads=3)
    for it in (mx.image.ImageRecordIter(**kw),
               mt.image.ImageRecordIter(ctx=mt.cpu(), **kw)):
        for records, pad in want:
            b = it.next()
            labels = [mt.test_utils.synthetic_image(2, i, 12, 50)[0]
                      for i in records]
            assert b.pad == pad
            np.testing.assert_array_equal(
                b.label[0].asnumpy(), np.float32(labels + [0] * pad))
        with pytest.raises(StopIteration):
            it.next()
        assert it.num_failed == len(corrupt)
