"""``gluon.data`` of the PyTorch package against the JAX package on the
CPU: ``tests/test_gluon.py``'s ``test_data_api`` and
``test_vision_datasets`` case for case, then the samplers' orders bit for
bit after one ``random.seed``, ``DataLoader``'s ``last_batch`` modes,
``num_workers`` and errors, the datasets' lazy and eager ``transform``,
the vision fixtures (and MNIST's and CIFAR's files where present) equal
to the JAX package's, ``RecordFileDataset``, ``ImageRecordDataset`` and
``ImageFolderDataset``.  Batches are host NDArrays.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.gluon.data import (ArrayDataset, DataLoader,
                                        RecordFileDataset, SimpleDataset)
from mxnet_tpu_torch.gluon.data import sampler as smp
from mxnet_tpu_torch.gluon.data import vision


@pytest.fixture(autouse=True)
def _decode_on_the_cpu():
    """JPEG decodes on the current context, the card by default: these
    cases hold the ``cpu()`` route (libjpeg) to the JAX package."""
    with mt.cpu():
        yield


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def test_data_api():
    X = np.random.randn(11, 3).astype("float32")
    Y = np.arange(11).astype("float32")
    ds = ArrayDataset(X, Y)
    assert len(ds) == 11
    dl = DataLoader(ds, batch_size=4, last_batch="keep")
    batches = list(dl)
    assert len(batches) == 3
    assert batches[0][0].shape == (4, 3)
    assert batches[2][0].shape == (3, 3)
    assert batches[0][0].context == mt.cpu()
    np.testing.assert_array_equal(batches[0][0].asnumpy(), X[:4])
    dl = DataLoader(ds, batch_size=4, shuffle=True, last_batch="discard")
    assert len(list(dl)) == 2
    dl = DataLoader(ds, batch_size=4, num_workers=2)
    assert len(list(dl)) == 3


def test_vision_datasets(tmp_path):
    m = vision.MNIST(root=str(tmp_path / "mnist"))
    assert m[0][0].shape == (28, 28, 1)
    c = vision.CIFAR10(root=str(tmp_path / "cifar"))
    assert c[0][0].shape == (32, 32, 3)
    assert not os.path.exists(tmp_path / "mnist")   # nothing is created


@pytest.mark.parametrize("kind", ["random", "sequential"])
@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_samplers_match_jax(kind, last):
    orders = []
    for pkg in (mt, mx):
        pkg.random.seed(13)
        data = pkg.gluon.data.sampler
        base = (data.RandomSampler(23) if kind == "random"
                else data.SequentialSampler(23))
        bs = data.BatchSampler(base, 5, last)
        orders.append(([list(map(int, b)) for b in bs],
                       [list(map(int, b)) for b in bs], len(bs)))
    assert orders[0] == orders[1]
    if kind == "random":
        flat = sum(orders[0][0], [])
        assert flat != sorted(flat)


def test_batch_sampler_rejects_unknown_mode():
    with pytest.raises(ValueError):
        list(smp.BatchSampler(smp.SequentialSampler(7), 3, "bogus"))


@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_matches_jax(last, workers):
    X = np.arange(46, dtype=np.float32).reshape(23, 2)
    Y = np.arange(23).astype(np.int32)
    outs = []
    for pkg in (mt, mx):
        pkg.random.seed(5)
        dl = pkg.gluon.data.DataLoader(pkg.gluon.data.ArrayDataset(X, Y),
                                       batch_size=4, shuffle=True,
                                       last_batch=last, num_workers=workers)
        outs.append([[(_np(a), _np(b)) for a, b in dl] for _ in range(2)]
                    + [len(dl)])
    assert outs[0][2] == outs[1][2]
    for ea, eb in zip(outs[0][:2], outs[1][:2]):
        assert len(ea) == len(eb)
        for (xa, ya), (xb, yb) in zip(ea, eb):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)


def test_dataloader_arguments_and_errors():
    ds = SimpleDataset(list(range(10)))
    with pytest.raises(ValueError):
        DataLoader(ds)
    with pytest.raises(ValueError):
        DataLoader(ds, batch_size=2, shuffle=True,
                   sampler=smp.SequentialSampler(10))
    with pytest.raises(ValueError):
        DataLoader(ds, batch_size=2,
                   batch_sampler=smp.BatchSampler(smp.SequentialSampler(10),
                                                  2))
    dl = DataLoader(ds, batch_sampler=smp.BatchSampler(
        smp.SequentialSampler(10), 3, "keep"),
        batchify_fn=lambda xs: sum(xs))
    assert list(dl) == [3, 12, 21, 9]

    class Broken(SimpleDataset):
        def __getitem__(self, idx):
            raise KeyError("sample %d" % idx)
    with pytest.raises(KeyError):
        list(DataLoader(Broken(list(range(4))), batch_size=2, num_workers=1))


def test_transform_lazy_and_eager():
    ds = ArrayDataset(np.arange(6, dtype=np.float32), np.arange(6))
    lazy = ds.transform(lambda x, y: (x * 2, y + 1))
    eager = ds.transform(lambda x, y: (x * 2, y + 1), lazy=False)
    assert type(eager).__name__ == "SimpleDataset"
    assert [lazy[i] for i in range(6)] == [eager[i] for i in range(6)]
    first = ds.transform_first(lambda x: x - 1)
    assert first[3] == (2.0, 3)
    single = SimpleDataset([1, 2, 3]).transform_first(lambda x: x * 10)
    assert single[2] == 30
    with pytest.raises(AssertionError):
        ArrayDataset(np.zeros(3), np.zeros(4))


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "CIFAR10",
                                  "CIFAR100"])
@pytest.mark.parametrize("train", [True, False])
def test_vision_fixtures_match_jax(tmp_path, name, train):
    a = getattr(vision, name)(root=str(tmp_path / "p"), train=train)
    b = getattr(mx.gluon.data.vision, name)(root=str(tmp_path / "j"),
                                            train=train)
    assert len(a) == len(b)
    for i in (0, 7, len(a) - 1):
        (xa, ya), (xb, yb) = a[i], b[i]
        assert xa.dtype == np.float32 and xa.context == mt.cpu()
        np.testing.assert_array_equal(xa.asnumpy(), xb.asnumpy())
        assert int(ya) == int(yb)


def test_mnist_reads_its_gz_files(tmp_path):
    mt.test_utils.write_mnist_idx(str(tmp_path), 50, 20)
    for train, n in ((True, 50), (False, 20)):
        a = vision.MNIST(root=str(tmp_path), train=train,
                         transform=lambda x, y: (x / 255, y))
        b = mx.gluon.data.vision.MNIST(root=str(tmp_path), train=train)
        assert len(a) == len(b) == n
        for i in (0, n - 1):
            np.testing.assert_array_equal(a[i][0].asnumpy(),
                                          b[i][0].asnumpy() / 255)
            assert a[i][1] == b[i][1]
        raw = mt.io._read_idx_file(str(tmp_path / mt.test_utils.MNIST_FILES[
            0 if train else 2]))
        np.testing.assert_array_equal(
            vision.MNIST(root=str(tmp_path), train=train)[1][0]
            .asnumpy()[:, :, 0], raw[1])


def test_cifar_reads_its_binary_files(tmp_path):
    rng = np.random.RandomState(0)
    rows = np.concatenate([rng.randint(0, 10, (8, 1)),
                           rng.randint(0, 256, (8, 3072))], 1).astype(np.uint8)
    for name in ["data_batch_%d.bin" % i for i in range(1, 6)] + \
            ["test_batch.bin"]:
        (tmp_path / name).write_bytes(rows.tobytes())
    a = vision.CIFAR10(root=str(tmp_path))
    b = mx.gluon.data.vision.CIFAR10(root=str(tmp_path))
    assert len(a) == len(b) == 40
    np.testing.assert_array_equal(a[9][0].asnumpy(), b[9][0].asnumpy())
    np.testing.assert_array_equal(
        a[1][0].asnumpy(),
        rows[1, 1:].reshape(3, 32, 32).transpose(1, 2, 0))
    assert a[1][1] == rows[1, 0]


def _image_rec(tmp_path, n=5):
    prefix = str(tmp_path / "imgs")
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    labels = []
    for i in range(n):
        label, img = mt.test_utils.synthetic_image(1, i, 16, classes=4)
        labels.append(label)
        rec.write_idx(i, recordio.pack(recordio.IRHeader(0, label, i, 0),
                                       mt._native.jpeg_encode(img)))
    rec.close()
    return prefix, labels


def test_record_file_dataset(tmp_path):
    prefix, _ = _image_rec(tmp_path)
    a = RecordFileDataset(prefix + ".rec")
    b = mx.gluon.data.RecordFileDataset(prefix + ".rec")
    assert len(a) == len(b) == 5
    assert all(a[i] == b[i] for i in range(5))


def test_image_record_dataset(tmp_path):
    pytest.importorskip("cv2")
    prefix, labels = _image_rec(tmp_path)
    a = vision.ImageRecordDataset(prefix + ".rec")
    b = mx.gluon.data.vision.ImageRecordDataset(prefix + ".rec")
    for i in range(5):
        (xa, ya), (xb, yb) = a[i], b[i]
        np.testing.assert_array_equal(xa.asnumpy(), xb.asnumpy())
        assert ya == yb == labels[i]
    batch = next(iter(DataLoader(
        vision.ImageRecordDataset(prefix + ".rec",
                                  transform=lambda x, y: (
                                      mt.image.imresize(x, 16, 16), y)),
        batch_size=5)))
    assert batch[0].shape == (5, 16, 16, 3)


def test_image_folder_dataset(tmp_path):
    pytest.importorskip("cv2")
    for k, cls in enumerate(("cat", "dog")):
        (tmp_path / cls).mkdir()
        for i in range(2):
            img = mt.test_utils.synthetic_image(3, 2 * k + i, 12)[1]
            (tmp_path / cls / ("%d.jpg" % i)).write_bytes(
                mt._native.jpeg_encode(img))
        (tmp_path / cls / "notes.txt").write_text("skip me")
    a = vision.ImageFolderDataset(str(tmp_path))
    b = mx.gluon.data.vision.ImageFolderDataset(str(tmp_path))
    assert a.synsets == b.synsets == ["cat", "dog"]
    assert len(a) == len(b) == 4
    for i in range(4):
        np.testing.assert_array_equal(a[i][0].asnumpy(), b[i][0].asnumpy())
        assert a[i][1] == b[i][1]
