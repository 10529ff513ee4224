"""``model.FeedForward`` of the PyTorch package against the JAX
package's, and against the port's own ``Module.fit``.

The MLP trains in fp64 through both packages' FeedForward, each taking
its ``Module``'s two-call path (``MXNET_MODULE_FUSED_STEP=0``: the JAX
package's one-call step rounds lr and wd to fp32, ROADMAP "Not
faults").  Parameters, predictions and the score are held to the JAX
package's within rtol 1e-12 (the packages' fp64 matmuls sum in different
orders); the port's FeedForward is held to the port's ``Module.fit`` with
the same initializer and data bit for bit, and ``save``/``load`` round
trip to the same predictions bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

PKGS = {"jax": mx, "torch": mt}
RTOL = 1e-12
OPT = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)


@pytest.fixture(autouse=True)
def _fp64_two_call(monkeypatch):
    """x64 on in JAX (another test may have turned it off in this
    worker) and the two-call Module path in both packages."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "0")
    with mt.cpu():
        yield
    jax.config.update("jax_enable_x64", prev)


def _mlp(pkg):
    data = pkg.sym.var("data")
    h = pkg.sym.FullyConnected(data, num_hidden=32, name="fc1")
    h = pkg.sym.Activation(h, act_type="relu", name="relu1")
    h = pkg.sym.FullyConnected(h, num_hidden=10, name="fc2")
    return pkg.sym.SoftmaxOutput(h, pkg.sym.var("softmax_label"),
                                 name="softmax")


def _data(pkg, n=96):
    """fp64 NDArrays (``NDArrayIter`` keeps an NDArray's dtype; a numpy
    float64 array it makes float32)."""
    rng = np.random.RandomState(7)
    x = rng.randn(n, 20)
    y = np.argmax(x @ rng.randn(20, 10), axis=1).astype(np.float64)
    return (pkg.nd.array(x, ctx=pkg.cpu(), dtype="float64"),
            pkg.nd.array(y, ctx=pkg.cpu(), dtype="float64"))


def _scored(pkg, model, x, y):
    return model.score(pkg.io.NDArrayIter(x, y, batch_size=16))


def _model(pkg, **kw):
    kw = dict(dict(num_epoch=2, numpy_batch_size=16, ctx=pkg.cpu(),
                   initializer=pkg.init.Xavier()), **kw)
    with pkg.name.NameManager():
        return pkg.model.FeedForward(_mlp(pkg), **kw, **OPT)


def _fitted(pkg, batches=None):
    x, y = _data(pkg)
    pkg.random.seed(3)
    model = _model(pkg).fit(x, y, batch_end_callback=batches)
    return model


def test_feedforward_matches_reference():
    got = {}
    for key, pkg in PKGS.items():
        x, y = _data(pkg)
        seen = []
        model = _fitted(pkg, lambda p: seen.append((p.epoch, p.nbatch)))
        assert seen == [(e, b) for e in range(2) for b in range(6)]
        params = {n: a.asnumpy() for n, a in model.arg_params.items()}
        got[key] = (params, model.predict(x), _scored(pkg, model, x, y))
        assert got[key][1].dtype == np.float64
    assert sorted(got["torch"][0]) == sorted(got["jax"][0])
    for n, want in got["jax"][0].items():
        np.testing.assert_allclose(got["torch"][0][n], want, rtol=RTOL,
                                   atol=1e-14, err_msg=n)
    np.testing.assert_allclose(got["torch"][1], got["jax"][1], rtol=RTOL,
                               atol=1e-14)
    assert got["torch"][2] == got["jax"][2] > 0.3


def test_feedforward_equals_module_fit():
    """The same initializer and data through ``Module.fit``: the same
    parameters and outputs, bit for bit."""
    x, y = _data(mt)
    model = _fitted(mt)
    mt.random.seed(3)
    it = mt.io.NDArrayIter(x, y, batch_size=16, shuffle=True)
    with mt.name.NameManager():
        mod = mt.mod.Module(_mlp(mt), data_names=["data"],
                            label_names=["softmax_label"], context=mt.cpu())
    mod.fit(it, num_epoch=2, optimizer="sgd", optimizer_params=OPT,
            initializer=mt.init.Xavier())
    arg, _ = mod.get_params()
    for n, a in model.arg_params.items():
        np.testing.assert_array_equal(a.asnumpy(), arg[n].asnumpy())
    # predict on arrays shuffles the rows, in both packages (its
    # NDArrayIter has shuffle=True): the same draw for both here
    mt.random.seed(9)
    got = model.predict(x)
    mt.random.seed(9)
    eval_it = mt.io.NDArrayIter(x, None, batch_size=16, shuffle=True)
    np.testing.assert_array_equal(got, mod.predict(eval_it).asnumpy())


def test_save_load_round_trip(tmp_path):
    x, _ = _data(mt)
    model = _fitted(mt)
    prefix = str(tmp_path / "ff")
    model.save(prefix)
    again = mt.model.FeedForward.load(prefix, 2, ctx=mt.cpu(),
                                      numpy_batch_size=16)
    assert again.begin_epoch == 2
    preds = []
    for m in (model, again):
        mt.random.seed(9)
        preds.append(m.predict(x))
    np.testing.assert_array_equal(preds[1], preds[0])
    ref = mx.model.FeedForward.load(prefix, 2, ctx=mx.cpu(),
                                    numpy_batch_size=16)
    mx.random.seed(9)
    np.testing.assert_allclose(ref.predict(_data(mx)[0]), preds[0],
                               rtol=RTOL, atol=1e-14)


def test_create_and_predict_without_fit():
    got = {}
    for key, pkg in PKGS.items():
        x, y = _data(pkg)
        pkg.random.seed(4)
        with pkg.name.NameManager():
            model = pkg.model.FeedForward.create(
                _mlp(pkg), x, y, ctx=pkg.cpu(), num_epoch=1,
                numpy_batch_size=32, initializer=pkg.init.Xavier(), **OPT)
        got[key] = model.predict(x)
        pkg.random.seed(4)
        fresh = _model(pkg)
        first = fresh.predict(x[:16])
        assert first.shape == (16, 10)
        assert fresh.arg_params is not None
        got[key + "_fresh"] = first
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=RTOL,
                               atol=1e-14)
    np.testing.assert_allclose(got["torch_fresh"], got["jax_fresh"],
                               rtol=RTOL, atol=1e-14)


def test_default_context_is_the_current_one():
    with mt.cpu():
        with mt.name.NameManager():
            model = mt.model.FeedForward(_mlp(mt))
    assert model.ctx == [mt.cpu()]
    assert mt.FeedForward is mt.model.FeedForward
    assert mt.model.BatchEndParam is mt.module.base_module.BatchEndParam


def test_default_context_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mt.context.Context._default, "value", None,
                        raising=False)
    with pytest.raises(mt.MXNetError):
        mt.model.FeedForward(_mlp(mt))


@pytest.mark.parametrize("dtype", ["float64", "float16", "int32"])
def test_ndarray_iter_keeps_an_ndarrays_dtype(dtype):
    """An NDArray keeps its dtype through ``NDArrayIter`` (a numpy float64
    array becomes float32), as in the JAX package."""
    x = np.arange(12).reshape(6, 2)
    for pkg in PKGS.values():
        it = pkg.io.NDArrayIter(pkg.nd.array(x, ctx=pkg.cpu(), dtype=dtype),
                                x.astype(np.float64), batch_size=3)
        assert np.dtype(it.provide_data[0].dtype) == np.dtype(dtype)
        assert np.dtype(it.provide_label[0].dtype) == np.float32
        batch = next(iter(it))
        assert batch.data[0].dtype == np.dtype(dtype)
        np.testing.assert_array_equal(batch.data[0].asnumpy(), x[:3])
