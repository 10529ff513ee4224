"""The PyTorch package's data iterators against the JAX package's on the
CPU, case for case with ``tests/test_io.py`` (``NDArrayIter``'s modes,
``ResizeIter``, ``CSVIter``, the ``provide_*`` semantics) and beyond it:
``PrefetchingIter`` over one and two sources with renames, ``MNISTIter``
over idx files written to ``tmp_path`` (batches, shuffle order after one
seed, ``flat``), ``test_utils.get_mnist(path)``, and ``LibSVMIter``'s
CSR batches (``tests/test_torch_sparse_train.py`` holds its modes).
Every batch is equal bit for bit.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu.test_utils  # noqa: F401 - mx.test_utils

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError


def _batches(it):
    out = []
    for b in it:
        out.append(([d.asnumpy() for d in b.data],
                    [l.asnumpy() for l in (b.label or [])], b.pad))
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for x, y in zip(da + la, db + lb):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def _descs(descs):
    return [(d.name, tuple(d.shape)) for d in descs]


def _both(make, seed=None):
    """The batches of ``make(pkg)`` in both packages (each after
    ``random.seed(seed)`` when a seed is given), two epochs each."""
    runs = []
    for pkg in (mt, mx):
        if seed is not None:
            pkg.random.seed(seed)
        it = make(pkg)
        runs.append((_batches(it), _descs(it.provide_data),
                     _descs(it.provide_label)))
        it.reset()
        runs[-1] = runs[-1] + (_batches(it),)
    return runs


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarrayiter_modes(handle, shuffle):
    data = np.arange(40, dtype=np.float32).reshape(10, 4)
    label = np.arange(10, dtype=np.float32)
    (a, ad, al, a2), (b, bd, bl, b2) = _both(
        lambda pkg: pkg.io.NDArrayIter(data, label, batch_size=4,
                                       shuffle=shuffle,
                                       last_batch_handle=handle), seed=3)
    _assert_same(a, b)
    _assert_same(a2, b2)
    assert ad == bd and al == bl


def test_resize_iter():
    data = np.arange(16, dtype=np.float32).reshape(8, 2)
    (a, ad, al, a2), (b, bd, bl, b2) = _both(
        lambda pkg: pkg.io.ResizeIter(pkg.io.NDArrayIter(data, batch_size=2),
                                      5))
    assert len(a) == 5
    _assert_same(a, b)
    _assert_same(a2, b2)
    assert ad == bd


def test_resize_iter_keeps_cursor_without_reset_internal():
    data = np.arange(16, dtype=np.float32).reshape(8, 2)
    firsts = []
    for pkg in (mt, mx):
        it = pkg.io.ResizeIter(pkg.io.NDArrayIter(data, batch_size=2), 3,
                               reset_internal=False)
        list(it)
        it.reset()
        firsts.append(it.next().data[0].asnumpy())
    np.testing.assert_array_equal(*firsts)
    np.testing.assert_array_equal(firsts[0], data[6:8])


def test_prefetching_iter_one_source():
    data = np.arange(30, dtype=np.float32).reshape(10, 3)
    label = np.arange(10, dtype=np.float32)
    (a, ad, al, a2), (b, bd, bl, b2) = _both(
        lambda pkg: pkg.io.PrefetchingIter(
            pkg.io.NDArrayIter(data, label, batch_size=4)))
    _assert_same(a, b)
    _assert_same(a2, b2)
    assert ad == bd and al == bl


def test_prefetching_iter_two_sources_renamed():
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    y = -np.arange(16, dtype=np.float32).reshape(8, 2)

    def make(pkg):
        return pkg.io.PrefetchingIter(
            [pkg.io.NDArrayIter(x, batch_size=4, data_name="a",
                                label_name="la"),
             pkg.io.NDArrayIter(y, batch_size=4, data_name="b",
                                label_name="lb")],
            rename_data=[{"a": "a2"}, {"b": "b2"}])
    (a, ad, al, a2), (b, bd, bl, b2) = _both(make)
    _assert_same(a, b)
    assert ad == bd == [("a2", (4, 3)), ("b2", (4, 2))]


def test_prefetching_iter_passes_errors_on():
    class Broken(mt.io.NDArrayIter):
        def next(self):
            raise ValueError("source failed")
    it = mt.io.PrefetchingIter(Broken(np.zeros((4, 2), np.float32),
                                      batch_size=2))
    with pytest.raises(ValueError, match="source failed"):
        it.next()


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter(tmp_path, round_batch):
    rng = np.random.RandomState(0)
    path, lpath = str(tmp_path / "data.csv"), str(tmp_path / "label.csv")
    arr = rng.randint(0, 9, (10, 6)).astype(np.float32)
    np.savetxt(path, arr, delimiter=",", fmt="%g")
    np.savetxt(lpath, np.arange(10), delimiter=",", fmt="%g")
    (a, ad, al, a2), (b, bd, bl, b2) = _both(
        lambda pkg: pkg.io.CSVIter(data_csv=path, data_shape=(2, 3),
                                   label_csv=lpath, batch_size=4,
                                   round_batch=round_batch))
    _assert_same(a, b)
    _assert_same(a2, b2)
    assert ad == bd == [("data", (4, 2, 3))]
    got = np.concatenate([d[0] for d, _, _ in a])
    np.testing.assert_array_equal(got[:10].reshape(10, 6), arr)


def test_csv_iter_without_labels(tmp_path):
    path = str(tmp_path / "data.csv")
    np.savetxt(path, np.ones((6, 3)), delimiter=",", fmt="%g")
    it = mt.io.CSVIter(data_csv=path, data_shape=(3,), batch_size=3)
    np.testing.assert_array_equal(it.next().label[0].asnumpy(), 0)


def _mnist_files(tmp_path, n=200, m=64):
    mt.test_utils.write_mnist_idx(str(tmp_path), n, m)
    return [str(tmp_path / name) for name in mt.test_utils.MNIST_FILES]


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_mnist_iter(tmp_path, flat, shuffle):
    files = _mnist_files(tmp_path)
    (a, ad, al, a2), (b, bd, bl, b2) = _both(
        lambda pkg: pkg.io.MNISTIter(image=files[0], label=files[1],
                                     batch_size=32, shuffle=shuffle,
                                     flat=flat), seed=11)
    _assert_same(a, b)
    _assert_same(a2, b2)
    assert ad == bd == [("data", (32, 784) if flat else (32, 1, 28, 28))]
    assert al == bl == [("softmax_label", (32,))]
    assert len(a) == 7 and a[-1][2] == 24


def test_mnist_iter_missing_file(tmp_path):
    with pytest.raises(MXNetError, match="not found"):
        mt.io.MNISTIter(image=str(tmp_path / "nope"),
                        label=str(tmp_path / "nope2"))


def test_idx_files_round_trip(tmp_path):
    imgs = np.random.RandomState(0).randint(0, 256, (5, 28, 28))
    mt.io.write_idx_file(str(tmp_path / "i"), imgs)
    mt.io.write_idx_file(str(tmp_path / "l"), np.arange(5))
    np.testing.assert_array_equal(mt.io._read_idx_file(str(tmp_path / "i")),
                                  imgs)
    np.testing.assert_array_equal(mx.io._read_idx_file(str(tmp_path / "i")),
                                  imgs)
    np.testing.assert_array_equal(mx.io._read_idx_file(str(tmp_path / "l")),
                                  np.arange(5))
    (tmp_path / "bad").write_bytes(b"\x00\x00\x00\x01\x00\x00\x00\x00")
    with pytest.raises(MXNetError, match="bad idx magic"):
        mt.io._read_idx_file(str(tmp_path / "bad"))


def test_get_mnist_reads_idx_files(tmp_path):
    _mnist_files(tmp_path)
    a = mt.test_utils.get_mnist(str(tmp_path))
    b = mx.test_utils.get_mnist(str(tmp_path))
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    assert a["train_data"].shape == (200, 1, 28, 28)
    # without the files: the synthetic digits, equal to the JAX package's
    a = mt.test_utils.get_mnist(str(tmp_path / "absent"))
    b = mx.test_utils.get_mnist(str(tmp_path / "absent"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_get_mnist_iterator(tmp_path):
    _mnist_files(tmp_path)
    runs = []
    for pkg in (mt, mx):
        pkg.random.seed(2)
        tr, va = pkg.test_utils.get_mnist_iterator(50, flat=True,
                                                   path=str(tmp_path))
        runs.append((_batches(tr), _batches(va)))
    _assert_same(runs[0][0], runs[1][0])
    _assert_same(runs[0][1], runs[1][1])


def test_dataiter_provide_semantics():
    data = np.zeros((8, 2, 3), np.float32)
    for pkg in (mt, mx):
        it = pkg.io.NDArrayIter(data, batch_size=4)
        desc = it.provide_data[0]
        assert tuple(desc.shape) == (4, 2, 3)
        assert desc.name == "data"
        assert desc == ("data", (4, 2, 3))
        name, shape = desc
        assert (name, shape) == ("data", (4, 2, 3))


def test_batches_live_on_the_host(tmp_path):
    files = _mnist_files(tmp_path)
    b = mt.io.MNISTIter(image=files[0], label=files[1], batch_size=8).next()
    assert b.data[0].context == mt.cpu() and b.label[0].context == mt.cpu()


def test_libsvm_iter_raises_naming_a9(tmp_path):
    """``tests/test_io.py::test_libsvm_iter`` in both packages (A.9 is
    ported): CSR batches with the JAX package's values, parts and
    labels, then ``StopIteration``."""
    f = tmp_path / "train.libsvm"
    f.write_text("1 0:1.5 3:2.0\n0 1:0.5\n1 2:3.0 3:1.0\n0 0:2.5\n")
    got = {}
    for pkg in (mt, mx):
        it = pkg.io.LibSVMIter(data_libsvm=str(f), data_shape=(4,),
                               batch_size=2)
        rows = []
        for _ in range(2):
            b = it.next()
            d = b.data[0]
            assert d.stype == "csr"
            rows.append([d.asnumpy(), d.data.asnumpy(), d.indices.asnumpy(),
                         d.indptr.asnumpy(), b.label[0].asnumpy(), b.pad])
        with pytest.raises(StopIteration):
            it.next()
        got[pkg] = rows
    for mine, theirs in zip(got[mt], got[mx]):
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[mt][0][0],
                                  [[1.5, 0, 0, 2.0], [0, 0.5, 0, 0]])
    np.testing.assert_array_equal(got[mt][1][0],
                                  [[0, 0, 3.0, 1.0], [2.5, 0, 0, 0]])
