"""``io.NDArrayIter`` and the metrics of the PyTorch package against the
JAX package's on the same arrays: the cases of ``tests/test_io.py`` and
``tests/test_metric.py`` that this package ports (NDArrayIter with
``pad``/``discard``/``roll_over``, dict data, seeded shuffles, the
provide semantics; Accuracy, TopKAccuracy, CrossEntropy and
NegativeLogLikelihood, the composite, ``create`` and the non-finite
rule).  Batches and metric values must be equal.
"""
import numpy as np
import pytest

import jax
import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError


@pytest.fixture(scope="module", autouse=True)
def x64():
    """The JAX package turns x64 on at import, and its iterator keeps int64
    labels only under it; another test in this worker may have turned it
    off."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _epoch(it):
    return [([d.asnumpy() for d in b.data], [l.asnumpy() for l in b.label],
             b.pad) for b in it]


def _same_batches(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for x, y in zip(da + la, db + lb):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _both(*args, **kwargs):
    return [pkg.io.NDArrayIter(*args, **kwargs) for pkg in (mx, mt)]


def test_ndarrayiter_basic():
    data = np.arange(40, dtype=np.float32).reshape(10, 4)
    label = np.arange(10, dtype=np.float32)
    jit, it = _both(data, label, batch_size=4, shuffle=False,
                    last_batch_handle="pad")
    batches = _epoch(it)
    _same_batches(batches, _epoch(jit))
    assert len(batches) == 3 and batches[-1][2] == 2
    np.testing.assert_array_equal(batches[0][0][0], data[:4])
    np.testing.assert_array_equal(batches[-1][0][0], data[[8, 9, 0, 1]])
    it.reset()
    jit.reset()
    _same_batches(_epoch(it), _epoch(jit))
    assert all(b.data[0].context == mt.cpu() for b in it)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_last_batch_handle_over_epochs(handle):
    data = np.arange(10, dtype=np.float32).reshape(10, 1)
    label = np.arange(10, dtype=np.int64)
    jit, it = _both(data, label, batch_size=4, last_batch_handle=handle)
    for _ in range(3):
        got, want = _epoch(it), _epoch(jit)
        _same_batches(got, want)
        it.reset()
        jit.reset()
    if handle == "discard":
        assert len(got) == 2


def test_ndarrayiter_dict_data_and_list():
    data = {"a": np.zeros((6, 2), np.float32),
            "b": np.ones((6, 3), np.float32)}
    jit, it = _both(data, batch_size=3)
    assert sorted(d.name for d in it.provide_data) == ["a", "b"]
    assert [(d.name, d.shape) for d in it.provide_data] == \
        [(d.name, d.shape) for d in jit.provide_data]
    _same_batches(_epoch(it), _epoch(jit))
    jit, it = _both([np.zeros((4, 2)), np.ones((4, 1))], batch_size=2)
    assert [d.name for d in it.provide_data] == \
        [d.name for d in jit.provide_data] == ["_0_data", "_1_data"]
    assert it.provide_data[0].dtype == np.float32  # float64 -> float32


def test_seeded_shuffle_matches():
    data = np.arange(48, dtype=np.float32).reshape(12, 4)
    label = np.arange(12, dtype=np.float32)
    mx.random.seed(17)
    jit = mx.io.NDArrayIter(data, label, batch_size=5, shuffle=True)
    mt.random.seed(17)
    it = mt.io.NDArrayIter(data, label, batch_size=5, shuffle=True)
    for _ in range(2):
        _same_batches(_epoch(it), _epoch(jit))
        it.reset()
        jit.reset()


def test_dataiter_provide_semantics():
    data = np.zeros((8, 2, 3), np.float32)
    jit, it = _both(data, np.zeros(8, np.int32), batch_size=4)
    for j, t in zip(jit.provide_data + jit.provide_label,
                    it.provide_data + it.provide_label):
        assert (t.name, tuple(t.shape), np.dtype(t.dtype)) == \
            (j.name, tuple(j.shape), np.dtype(j.dtype))
    desc = it.provide_data[0]
    assert tuple(desc.shape) == (4, 2, 3) and desc.name == "data"
    assert desc == ("data", (4, 2, 3)) and list(desc) == ["data", (4, 2, 3)]
    assert it.provide_label[0].name == "softmax_label"
    with pytest.raises(ValueError):
        mt.io.NDArrayIter(data, batch_size=9)


def _update(pkg, metric, labels, preds):
    ctx = pkg.cpu()
    metric.update([pkg.nd.array(l, ctx=ctx) for l in labels],
                  [pkg.nd.array(p, ctx=ctx) for p in preds])
    return metric.get()


METRIC_CASES = [
    ("Accuracy", {}, [np.array([1, 0, 0])],
     [np.array([[0.3, 0.7], [0.9, 0.1], [0.4, 0.6]])]),
    ("Accuracy", {"axis": 1}, [np.array([[1, 2], [0, 0]])],
     [np.random.RandomState(1).rand(2, 3, 2)]),
    ("TopKAccuracy", {"top_k": 2}, [np.array([2, 2])],
     [np.array([[0.1, 0.5, 0.4], [0.8, 0.15, 0.05]])]),
    ("TopKAccuracy", {"top_k": 3}, [np.arange(6) % 5],
     [np.random.RandomState(2).rand(6, 5)]),
    ("CrossEntropy", {}, [np.array([1, 0])],
     [np.array([[0.2, 0.8], [0.9, 0.1]])]),
    ("NegativeLogLikelihood", {}, [np.array([2, 0, 1])],
     [np.random.RandomState(3).dirichlet(np.ones(3), 3)]),
]


@pytest.mark.parametrize("name,kw,labels,preds", METRIC_CASES)
def test_metrics_match(name, kw, labels, preds):
    want = _update(mx, getattr(mx.metric, name)(**kw), labels, preds)
    got = _update(mt, getattr(mt.metric, name)(**kw), labels, preds)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


def test_accuracy_and_cross_entropy_values():
    _, acc = _update(mt, mt.metric.Accuracy(), *METRIC_CASES[0][2:])
    assert abs(acc - 2.0 / 3) < 1e-6
    _, ce = _update(mt, mt.metric.CrossEntropy(), *METRIC_CASES[4][2:])
    assert abs(ce - -(np.log(0.8) + np.log(0.9)) / 2) < 1e-5


def test_composite_and_create():
    for pkg in (mx, mt):
        comp = pkg.metric.CompositeEvalMetric()
        comp.add(pkg.metric.Accuracy())
        comp.add("ce")
        names, vals = _update(pkg, comp, [np.array([1])],
                              [np.array([[0.3, 0.7]])])
        assert names == ["accuracy", "cross-entropy"]
        assert vals[0] == 1.0 and abs(vals[1] + np.log(0.7)) < 1e-6
    for alias, cls in (("acc", "Accuracy"), ("top_k_accuracy",
                                             "TopKAccuracy"),
                       ("ce", "CrossEntropy"),
                       ("nll_loss", "NegativeLogLikelihood")):
        kw = {"top_k": 2} if cls == "TopKAccuracy" else {}
        assert type(mt.metric.create(alias, **kw)).__name__ == cls
        assert type(mx.metric.create(alias, **kw)).__name__ == cls
    bundle = mt.metric.create(["acc", "ce"])
    assert [m.name for m in bundle.metrics] == ["accuracy", "cross-entropy"]
    m = mt.metric.create("acc")
    _update(mt, m, [np.array([1])], [np.array([[0.3, 0.7]])])
    assert m.get() == ("accuracy", 1.0)
    m.reset()
    assert np.isnan(m.get()[1])
    with pytest.raises(MXNetError):
        mt.metric.create("no_such_metric")  # unknown names raise


def test_nonfinite_updates_are_excluded_and_counted():
    """A NaN contribution is left out of the running sum and counted."""
    before = mt.metric.nonfinite_updates()
    results = []
    for pkg in (mx, mt):
        m = pkg.metric.CrossEntropy()
        good = np.array([[0.2, 0.8], [0.9, 0.1]])
        _update(pkg, m, [np.array([1, 0])], [good])
        _update(pkg, m, [np.array([1, 0])],
                [np.array([[0.2, np.nan], [0.9, 0.1]])])
        results.append((m.get(), m.num_inst))
    assert results[0] == results[1] and results[1][1] == 2
    assert mt.metric.nonfinite_updates() == before + 1
