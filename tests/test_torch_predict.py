"""``Predictor`` (``mxnet_tpu_torch/predict.py``) against the JAX
package's on the CPU.

- ``tests/test_module.py::test_predictor_from_checkpoint`` and
  ``tests/test_predict_capi.py::test_predictor_rejects_missing_weight``,
  case for case.
- A checkpoint the JAX package wrote (``Module.save_checkpoint``), read
  by the port's ``Predictor``, gives the JAX ``Predictor``'s outputs
  within 1e-6 in fp32 and 1e-12 in fp64 (inputs exact in fp32: the JAX
  package binds its inputs at float32 and promotes, the port binds them
  at the parameters' dtype).
- ``*_label`` arguments bound to zeros; a missing weight or aux state,
  an unknown input or a wrong shape raises; the default context is the
  card, which with no card raises.
- Under a stand-in graph class one capture for the input shape, then one
  replay a ``forward``.
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx
from mxnet_tpu.predict import Predictor as RefPredictor

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, capture, profiler


@pytest.fixture(scope="module", autouse=True)
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


class StandIn:
    """A test-only graph: ``capture`` runs the function once, ``replay``
    runs it again into the captured outputs."""
    warmup_runs = 0

    def __init__(self, device, pool, generators):
        pass

    @staticmethod
    def pool(device):
        return None

    def capture(self, fn):
        self._fn = fn
        self._outs = [o.detach() for o in fn()]
        return self._outs

    def replay(self):
        with torch.no_grad():
            for dst, src in zip(self._outs, self._fn()):
                dst.copy_(src)


def test_predictor_from_checkpoint(tmp_path):
    """Save a trained Module, reload through Predictor: the outputs match
    ``Module.predict`` (``tests/test_module.py:228``)."""
    np.random.seed(0)
    X = np.random.randn(32, 6).astype(np.float32)
    Y = np.random.randint(0, 3, 32).astype(np.float32)
    with mt.cpu():
        it = mt.io.NDArrayIter(X, Y, batch_size=8)
        net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
            mt.sym.Variable("data"), num_hidden=3, name="pfc"),
            name="softmax")
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.fit(it, num_epoch=2, optimizer_params={"learning_rate": 0.1})
        prefix = str(tmp_path / "pred")
        mod.save_checkpoint(prefix, 2)
        pred = mt.Predictor.load(prefix, 2, input_shapes={
            "data": (8, 6), "softmax_label": (8,)})
        out = pred.forward(data=X[:8])[0].asnumpy()
        mod_out = mod.predict(mt.io.NDArrayIter(X[:8], Y[:8], batch_size=8))
    np.testing.assert_allclose(out, mod_out.asnumpy(), rtol=1e-5, atol=1e-6)


def _mlp(pkg, bn=False):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    if bn:
        net = pkg.sym.BatchNorm(net, name="bn1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _jax_checkpoint(tmp_path, dtype, bn=True):
    """A JAX Module over the MLP (with BatchNorm), one SGD step, saved as
    ``prefix``-symbol.json / -0001.params."""
    rng = np.random.RandomState(7)
    x = rng.randn(16, 10).astype(np.float32).astype(dtype)
    y = rng.randint(0, 4, 16).astype(dtype)
    with mx.cpu():
        mod = mx.mod.Module(_mlp(mx, bn), context=mx.cpu())
        mod.bind([mx.io.DataDesc("data", (16, 10), dtype=dtype)],
                 [mx.io.DataDesc("softmax_label", (16,), dtype=dtype)])
        mx.random.seed(3)
        mod.init_params(initializer=mx.init.Xavier())
        mod.init_optimizer(optimizer_params=(("learning_rate", 0.1),))
        mod.forward(mx.io.DataBatch([mx.nd.array(x, dtype=dtype)],
                                    [mx.nd.array(y, dtype=dtype)]))
        mod.backward()
        mod.update()
        prefix = str(tmp_path / ("ref_" + dtype))
        mod.save_checkpoint(prefix, 1)
    return prefix


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("float64", 1e-12)])
def test_jax_checkpoint_through_the_ports_predictor(tmp_path, dtype, tol):
    prefix = _jax_checkpoint(tmp_path, dtype)
    rng = np.random.RandomState(8)
    x = rng.randn(4, 10).astype(np.float32)
    ref = RefPredictor.load(prefix, 1, {"data": (4, 10)}, ctx=mx.cpu())
    want = ref.forward(data=x)[0].asnumpy()
    pred = mt.Predictor.load(prefix, 1, {"data": (4, 10)}, ctx=mt.cpu())
    got = pred.forward(data=x)[0].asnumpy()
    assert got.dtype == want.dtype == np.dtype(dtype)
    assert pred.output_names == ref.output_names
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_array_equal(pred.get_output(0).asnumpy(), got)


def test_label_arguments_are_zero_bound(tmp_path):
    prefix = _jax_checkpoint(tmp_path, "float32")
    pred = mt.Predictor.load(prefix, 1, {"data": (3, 10)}, ctx=mt.cpu())
    ref = RefPredictor.load(prefix, 1, {"data": (3, 10)}, ctx=mx.cpu())
    for p in (pred, ref):
        label = p._exe.arg_dict["softmax_label"].asnumpy()
        assert label.shape == (3,) and not label.any()


@pytest.mark.parametrize("missing", ["fc1_weight", "bn1_moving_var"])
def test_predictor_rejects_missing_weight(tmp_path, missing):
    """Zero-binding is for ``*_label`` arguments only: a missing weight
    or aux state raises naming it, in both packages
    (``tests/test_predict_capi.py:158``)."""
    prefix = _jax_checkpoint(tmp_path, "float32")
    for pkg, cls, ctx in ((mt, mt.Predictor, mt.cpu()),
                          (mx, RefPredictor, mx.cpu())):
        sym, arg, aux = pkg.model.load_checkpoint(prefix, 1)
        (arg if missing in arg else aux).pop(missing)
        with pytest.raises(pkg.base.MXNetError, match=missing):
            cls(sym, arg, aux, {"data": (2, 10)}, ctx=ctx)


def test_predictor_refusals(tmp_path):
    prefix = _jax_checkpoint(tmp_path, "float32")
    pred = mt.Predictor.load(prefix, 1, {"data": (2, 10)}, ctx=mt.cpu())
    with pytest.raises(MXNetError, match="run forward"):
        pred.get_output(0)
    with pytest.raises(MXNetError, match="unknown input"):
        pred.set_input(image=np.zeros((2, 10), np.float32))
    with pytest.raises(MXNetError, match="bound at"):
        pred.set_input(data=np.zeros((3, 10), np.float32))


def test_default_context_is_the_card(tmp_path, monkeypatch):
    prefix = _jax_checkpoint(tmp_path, "float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError):
        mt.Predictor.load(prefix, 1, {"data": (2, 10)})
    with mt.cpu():
        pred = mt.Predictor.load(prefix, 1, {"data": (2, 10)})
    assert pred._exe.arg_dict["data"].context == mt.cpu()


def test_one_capture_then_replays(tmp_path):
    """The forward is the executor's eval program: a capture at the first
    call, a replay at each, equal to the eager run."""
    prefix = _jax_checkpoint(tmp_path, "float32")
    rng = np.random.RandomState(9)
    xs = [rng.randn(2, 10).astype(np.float32) for _ in range(3)]
    eager = mt.Predictor.load(prefix, 1, {"data": (2, 10)}, ctx=mt.cpu())
    want = [eager.forward(data=x)[0].asnumpy() for x in xs]
    with capture.stand_in(StandIn):
        pred = mt.Predictor.load(prefix, 1, {"data": (2, 10)}, ctx=mt.cpu())
        counts = []
        for x, w in zip(xs, want):
            before = profiler.counters()
            got = pred.forward(data=mt.nd.array(x, ctx=mt.cpu()))[0]
            now = profiler.counters()
            counts.append(tuple(now.get(k, 0) - before.get(k, 0)
                                for k in ("graph_captures",
                                          "graph_replays")))
            np.testing.assert_array_equal(got.asnumpy(), w)
    assert counts == [(1, 1), (0, 1), (0, 1)]


def test_predict_namespace():
    assert mt.predict.Predictor is mt.Predictor
    assert "Predictor" in mt.__all__ and "predict" in mt.__all__
