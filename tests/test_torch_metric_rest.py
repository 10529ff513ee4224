"""The PyTorch package's metrics against the JAX package's, on the CPU.

Mirrors ``tests/test_metric.py`` case for case: each case runs in both
packages on the same inputs, checks the reference test's own expectation
in this package, and holds the two packages' readings equal (1e-12
relative: the same numpy arithmetic on the same arrays).  Also held: the
registered names, ``create`` of each, and ``Perplexity`` with an
``ignore_label`` on sequence-shaped labels, whose ignored positions do
not move it.
"""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

SAME = dict(rtol=1e-12, atol=0)


def both(make, labels, preds):
    """(JAX package's get(), this package's get()) after one update."""
    out = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        m = make(pkg)
        m.update([pkg.nd.array(np.asarray(x), ctx=ctx) for x in labels],
                 [pkg.nd.array(np.asarray(x), ctx=ctx) for x in preds])
        out.append(m.get())
    assert out[0][0] == out[1][0]
    np.testing.assert_allclose(out[1][1], out[0][1], **SAME)
    return out[1]


def test_accuracy():
    name, acc = both(lambda p: p.metric.Accuracy(),
                     [np.array([1, 0, 0])],
                     [np.array([[0.3, 0.7], [0.9, 0.1], [0.4, 0.6]])])
    assert name == "accuracy" and abs(acc - 2.0 / 3) < 1e-6


def test_topk_accuracy():
    _, acc = both(lambda p: p.metric.TopKAccuracy(top_k=2),
                  [np.array([2, 2])],
                  [np.array([[0.1, 0.5, 0.4], [0.8, 0.15, 0.05]])])
    assert abs(acc - 0.5) < 1e-6


@pytest.mark.parametrize("name,expect", [
    ("MSE", (0.25 + 1.0) / 2), ("MAE", (0.5 + 1.0) / 2),
    ("RMSE", np.sqrt((0.25 + 1.0) / 2))])
def test_mse_mae_rmse(name, expect):
    _, v = both(lambda p: getattr(p.metric, name)(),
                [np.array([[1.5], [1.0]])], [np.array([[1.0], [2.0]])])
    assert abs(v - expect) < 1e-5


def test_cross_entropy_and_nll():
    pred, label = np.array([[0.2, 0.8], [0.9, 0.1]]), np.array([1, 0])
    _, v = both(lambda p: p.metric.CrossEntropy(), [label], [pred])
    assert abs(v + (np.log(0.8) + np.log(0.9)) / 2) < 1e-5
    _, nll = both(lambda p: p.metric.NegativeLogLikelihood(), [label],
                  [pred])
    assert nll == v


def test_perplexity():
    _, v = both(lambda p: p.metric.Perplexity(ignore_label=None),
                [np.array([0, 1])], [np.array([[0.5, 0.5], [0.5, 0.5]])])
    assert abs(v - 2.0) < 1e-4


def test_perplexity_ignores_padding():
    """Sequence labels (batch, T) against (batch * T, vocab) scores: the
    positions labelled ``ignore_label`` neither add to the sum nor to the
    count, whatever their scores."""
    rng = np.random.RandomState(0)
    label = rng.randint(1, 6, (3, 4)).astype(np.float64)
    label[:, -1] = 0
    scores = rng.rand(12, 6)
    pred = scores / scores.sum(1, keepdims=True)
    _, v = both(lambda p: p.metric.Perplexity(ignore_label=0), [label],
                [pred])
    other = pred.copy()
    other[label.ravel() == 0] = 1.0 / 6
    _, w = both(lambda p: p.metric.Perplexity(ignore_label=0), [label],
                [other])
    kept = label.ravel() != 0
    picked = pred[np.arange(12), label.ravel().astype(int)][kept]
    # nd.array keeps the float32 of the metric's arrays
    want = np.exp(-np.log(picked.astype(np.float32)).mean())
    assert v == w and abs(v - want) < 1e-6 * want


def test_f1():
    _, f1 = both(lambda p: p.metric.F1(), [np.array([0, 1, 1, 1])],
                 [np.array([[0.7, 0.3], [0.2, 0.8], [0.1, 0.9],
                            [0.6, 0.4]])])
    assert abs(f1 - 0.8) < 1e-6


def test_composite_and_custom():
    pred, label = np.array([[0.3, 0.7]]), np.array([1])

    def composite(pkg):
        comp = pkg.metric.CompositeEvalMetric()
        comp.add(pkg.metric.Accuracy())
        comp.add(pkg.metric.MSE())
        return comp
    got = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        comp = composite(pkg)
        comp.update([pkg.nd.array(label, ctx=ctx)],
                    [pkg.nd.array(pred, ctx=ctx)])
        got.append(comp.get())
    assert got[0] == got[1] and len(got[1][0]) == 2

    def feval(lab, p):
        return float(np.abs(lab - p.argmax(axis=1)).mean())
    name, v = both(lambda p: p.metric.create(feval), [label], [pred])
    assert v == 0.0 and name == "feval"
    _, v = both(lambda p: p.metric.np(feval), [label], [pred])
    assert v == 0.0


def test_metric_create_by_name_and_reset():
    m = mt.metric.create("acc")
    m.update([mt.nd.array(np.array([1]), ctx=mt.cpu())],
             [mt.nd.array(np.array([[0.3, 0.7]]), ctx=mt.cpu())])
    assert m.get()[1] == 1.0
    m.reset()
    assert np.isnan(m.get()[1])


def test_pearson():
    _, v = both(lambda p: p.metric.PearsonCorrelation(),
                [np.array([[1.1], [2.2], [2.9], [4.1]])],
                [np.array([[1.0], [2.0], [3.0], [4.0]])])
    assert v > 0.99


@pytest.mark.parametrize("name", ["Loss", "Torch", "Caffe"])
def test_loss_family(name):
    got = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        m = getattr(pkg.metric, name)()
        m.update(None, [pkg.nd.array(np.array([1.0, 2.0, 4.5]), ctx=ctx)])
        got.append(m.get())
    assert got[0] == got[1] == (name.lower(), 7.5 / 3)


def test_nonfinite_updates_are_excluded_and_counted():
    before = mt.metric.nonfinite_updates()
    m = mt.metric.MAE()
    good = mt.nd.array(np.array([[1.0], [2.0]]), ctx=mt.cpu())
    m.update([good], [good])
    bad = mt.nd.array(np.array([[np.nan], [2.0]]), ctx=mt.cpu())
    m.update([good], [bad])
    m.update([good], [good])
    assert m.get()[1] == 0.0 and m.num_inst == 2
    assert mt.metric.nonfinite_updates() == before + 1
    loss = mt.metric.Loss()
    loss.update(None, [mt.nd.array(np.array([1.0, 2.0]), ctx=mt.cpu())])
    loss.update(None, [mt.nd.array(np.array([np.inf, 2.0]), ctx=mt.cpu())])
    v = loss.get()[1]
    assert np.isfinite(v) and v == 1.5
    assert mt.metric.nonfinite_updates() == before + 2
    p = mt.metric.Perplexity(ignore_label=None)
    label = mt.nd.array(np.array([0, 1]), ctx=mt.cpu())
    p.update([label], [mt.nd.array(np.array([[0.5, 0.5], [0.4, 0.6]]),
                                   ctx=mt.cpu())])
    p.update([label], [mt.nd.array(np.array([[np.nan, 0.5], [0.4, 0.6]]),
                                   ctx=mt.cpu())])
    assert np.isfinite(p.get()[1])
    assert mt.metric.nonfinite_updates() == before + 3


NAMES = ["acc", "accuracy", "top_k_accuracy", "top_k_acc", "f1",
         "perplexity", "mae", "mse", "rmse", "ce", "crossentropy",
         "nll_loss", "negativeloglikelihood", "pearsonr",
         "pearsoncorrelation", "loss", "torch", "caffe", "composite",
         "compositeevalmetric", "custommetric"]


def test_registered_names_are_the_jax_packages():
    """Every name the JAX package registers creates the same class here."""
    for name in NAMES:
        ref = mx.metric._REG.get(name)
        assert type(mt.metric._REGISTRY[name]) is type(ref)
        assert mt.metric._REGISTRY[name].__name__ == ref.__name__
    assert sorted(mt.metric._REGISTRY) == mx.metric._REG.names()
