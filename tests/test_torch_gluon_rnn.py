"""The PyTorch package's ``gluon.rnn`` against the JAX package's, on the
CPU.

Mirrors ``tests/test_gluon.py::test_rnn_cells_and_layers`` and
``::test_gru_rnn_layers``, then holds every cell and layer against the
JAX package's from one seeded init (both draw from ``random.host_rng()``)
in fp64: outputs, states and the gradients of every parameter and input
within 1e-12 (the same recurrences summed in other orders; readings near
1e-16).  The word LM of ``chip_smoke.py`` (``word_lm_model``, phase 24)
at a small size trains 3 steps in both packages from one init
(dropout 0): fp64 weights within 1e-10.  Also: a JAX package's
``save_params`` file loads into the layer by name; ``hybrid_forward``
raises as the JAX package's does.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import capture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=0, atol=1e-12)
TRAIN_TOL = dict(rtol=0, atol=1e-10)
T, N, C, H = 4, 3, 5, 6


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cap = _load("test_torch_capture", "tests/test_torch_capture.py")
smoke = _load("chip_smoke", "chip_smoke.py")


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


def test_rnn_cells_and_layers():
    """The fused LSTM against its own cell unrolled on the layer's
    weights (the JAX package's test), in this package."""
    with mt.cpu():
        x = mt.nd.array(np.random.RandomState(0).randn(4, 2, 3)
                        .astype("float32"))
        lstm = mt.gluon.rnn.LSTM(5, input_size=3)
        lstm.initialize(mt.init.Xavier())
        out = lstm(x)
        assert out.shape == (4, 2, 5)
        cell = mt.gluon.rnn.LSTMCell(5, input_size=3, params=None,
                                     prefix="c_")
        cell.initialize()
        for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
            getattr(cell, name).set_data(getattr(lstm, "l0_" + name).data())
        outs, _ = cell.unroll(4, mt.nd.swapaxes(x, 0, 1), layout="NTC")
        manual = np.stack([o.asnumpy() for o in outs], axis=0)
    np.testing.assert_allclose(manual, out.asnumpy(), rtol=1e-4, atol=1e-5)


def test_gru_rnn_layers():
    with mt.cpu():
        x = mt.nd.array(np.random.RandomState(1).randn(4, 2, 3)
                        .astype("float32"))
        for layer in (mt.gluon.rnn.GRU(5),
                      mt.gluon.rnn.RNN(5, activation="tanh")):
            layer.initialize()
            assert layer(x).shape == (4, 2, 5)
        bi = mt.gluon.rnn.LSTM(5, num_layers=2, bidirectional=True)
        bi.initialize()
        out, states = bi(x, bi.begin_state(2))
    assert out.shape == (4, 2, 10)
    assert states[0].shape == (4, 2, 5)


def _fp64(pkg, block, ctx):
    block.cast("float64")
    pkg.random.seed(7)
    block.initialize(pkg.init.Xavier(), ctx=ctx)
    return block


def _grads(pkg, block, xs):
    params = [p for p in block.collect_params().values()
              if p.grad_req != "null"]
    return {p.name: p.grad().asnumpy().copy() for p in params}, \
        [x.grad.asnumpy().copy() for x in xs]


def run_cell(pkg, ctx, make, merge):
    """Unroll a cell over seeded fp64 inputs under ``record``, backward
    from seeded heads: outputs, states, parameter and input gradients."""
    cell = _fp64(pkg, make(pkg), ctx)
    rng = np.random.RandomState(2)
    x = pkg.nd.array(rng.randn(N, T, C), ctx=ctx, dtype="float64")
    x.attach_grad()
    begin = cell.begin_state(batch_size=N, ctx=ctx, dtype="float64")
    with pkg.autograd.record():
        outs, states = cell.unroll(T, x, begin_state=begin, layout="NTC",
                                   merge_outputs=merge)
        heads = outs if isinstance(outs, list) else [outs]
        heads = heads + list(states)
        loss = None
        for h in heads:
            term = (h * pkg.nd.array(rng.randn(*h.shape), ctx=ctx,
                                     dtype="float64")).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    grads, xgrads = _grads(pkg, cell, [x])
    return [h.asnumpy() for h in heads], grads, xgrads


CELLS = {
    "rnn": lambda p: p.gluon.rnn.RNNCell(H, input_size=C, prefix="r_"),
    "lstm": lambda p: p.gluon.rnn.LSTMCell(H, input_size=C, prefix="l_"),
    "gru": lambda p: p.gluon.rnn.GRUCell(H, input_size=C, prefix="g_"),
    "deferred_gru": lambda p: p.gluon.rnn.GRUCell(H, prefix="d_"),
    "sequential": lambda p: _stack(p),
    "bidirectional": lambda p: p.gluon.rnn.BidirectionalCell(
        p.gluon.rnn.LSTMCell(H, input_size=C, prefix="bl_"),
        p.gluon.rnn.GRUCell(H, input_size=C, prefix="br_")),
}


def _stack(pkg):
    stack = pkg.gluon.rnn.SequentialRNNCell(prefix="s_")
    with stack.name_scope():
        stack.add(pkg.gluon.rnn.LSTMCell(H, input_size=C))
        stack.add(pkg.gluon.rnn.DropoutCell(0.0))
        stack.add(pkg.gluon.rnn.ResidualCell(
            pkg.gluon.rnn.GRUCell(H, input_size=H)))
        stack.add(pkg.gluon.rnn.ZoneoutCell(
            pkg.gluon.rnn.RNNCell(H, input_size=H)))
    return stack


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("merge", [True, False], ids=["merged", "steps"])
def test_cell_fp64_against_jax(name, merge):
    want = run_cell(mx, mx.cpu(), CELLS[name], merge)
    got = run_cell(mt, mt.cpu(), CELLS[name], merge)
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, **TOL)
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], err_msg=k, **TOL)
    np.testing.assert_allclose(got[2][0], want[2][0], **TOL)


def run_layer(pkg, ctx, kind, layers, bi, layout, states):
    make = {"lstm": lambda: pkg.gluon.rnn.LSTM(
                H, layers, layout=layout, bidirectional=bi, prefix="x_"),
            "gru": lambda: pkg.gluon.rnn.GRU(
                H, layers, layout=layout, bidirectional=bi, prefix="x_"),
            "rnn_relu": lambda: pkg.gluon.rnn.RNN(
                H, layers, layout=layout, bidirectional=bi, prefix="x_")}
    layer = _fp64(pkg, make[kind](), ctx)
    rng = np.random.RandomState(3)
    shape = (T, N, C) if layout == "TNC" else (N, T, C)
    x = pkg.nd.array(rng.randn(*shape), ctx=ctx, dtype="float64")
    x.attach_grad()
    scale = 0.5 if states else 0.0
    begin = [pkg.nd.array(rng.randn(*s["shape"]) * scale, ctx=ctx,
                          dtype="float64") for s in layer.state_info(N)]
    with pkg.autograd.record():
        # the JAX package's layer makes fp32 zero states for fp64 inputs,
        # which its scan refuses: it is given fp64 zeros instead
        res = layer(x) if not states and pkg is mt else layer(x, begin)
        res = res if states or pkg is mt else res[0]
        heads = [res[0]] + list(res[1]) if states else [res]
        loss = None
        for h in heads:
            term = (h * pkg.nd.array(rng.randn(*h.shape), ctx=ctx,
                                     dtype="float64")).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    grads, xgrads = _grads(pkg, layer, [x])
    return [h.asnumpy() for h in heads], grads, xgrads


LAYERS = [("lstm", 2, True, "TNC", True), ("lstm", 1, False, "NTC", False),
          ("gru", 2, False, "TNC", True), ("gru", 1, True, "NTC", False),
          ("rnn_relu", 2, True, "TNC", False)]


@pytest.mark.parametrize("kind,layers,bi,layout,states", LAYERS,
                         ids=["-".join(map(str, c)) for c in LAYERS])
def test_layer_fp64_against_jax(kind, layers, bi, layout, states):
    want = run_layer(mx, mx.cpu(), kind, layers, bi, layout, states)
    got = run_layer(mt, mt.cpu(), kind, layers, bi, layout, states)
    for g, w in zip(got[0], want[0]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], err_msg=k, **TOL)
    np.testing.assert_allclose(got[2][0], want[2][0], **TOL)


def test_layer_loads_the_jax_packages_params(tmp_path):
    """A JAX package's ``save_params`` file, loaded here by name (the
    per-layer ``i2h``/``h2h`` weights and biases), scores the same."""
    f = str(tmp_path / "lstm.params")
    x = np.random.RandomState(4).randn(T, N, C)
    ref = mx.gluon.rnn.LSTM(H, 2, input_size=C, prefix="m_")
    mx.random.seed(1)
    ref.initialize(mx.init.Xavier(), ctx=mx.cpu())
    want = ref(mx.nd.array(x)).asnumpy()
    ref.save_params(f)
    layer = mt.gluon.rnn.LSTM(H, 2, input_size=C, prefix="m_")
    layer.load_params(f, ctx=mt.cpu())
    got = layer(mt.nd.array(x, ctx=mt.cpu())).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_layer_is_not_hybridizable():
    layer = mt.gluon.rnn.GRU(H, input_size=C)
    layer.initialize(ctx=mt.cpu())
    with pytest.raises(NotImplementedError):
        layer.hybrid_forward(mt.nd, None)
    layer.hybridize()
    out = layer(mt.nd.ones((T, N, C), ctx=mt.cpu()))
    assert out.shape == (T, N, H)


def test_layer_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    layer = mt.gluon.rnn.LSTM(H, input_size=C)
    with pytest.raises(mt.MXNetError):
        layer.initialize()


SMALL_LM = dict(vocab=30, emsize=8, nhid=10, layers=2, dropout=0.0,
                batch=4, bptt=5)


def test_word_lm_three_steps_against_jax_fp64(monkeypatch):
    """chip_smoke's (b) at a small size: the first step's logits and
    gradients and the weights after 3 steps, against the JAX package
    through its per-parameter update (its fused Trainer step rounds lr
    and wd to fp32 whatever the weights' dtype,
    ``mxnet_tpu/gluon/fused_trainer.py:596-601``, 1e-8 of each update;
    this package's fused step keeps them in fp64)."""
    from mxnet_tpu.gluon import fused_trainer
    monkeypatch.setenv("MXNET_FUSED_TRAINER", "0")
    fused_trainer.refresh_from_env()
    try:
        with mx.cpu():
            want = smoke.word_lm_parity_run(mx, mx.cpu(), SMALL_LM, 3)
    finally:
        monkeypatch.delenv("MXNET_FUSED_TRAINER")
        fused_trainer.refresh_from_env()
    got = smoke.word_lm_parity_run(mt, mt.cpu(), SMALL_LM, 3)
    np.testing.assert_allclose(got["logits"], want["logits"], **TOL)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k in want["grads"]:
        np.testing.assert_allclose(got["grads"][k], want["grads"][k],
                                   err_msg=k, **TOL)
    for k in want["params"]:
        np.testing.assert_allclose(got["params"][k], want["params"][k],
                                   err_msg=k, **TRAIN_TOL)


def test_chip_smoke_word_lm_phase_on_the_cpu():
    """Phase 24's run at a small size, dropout live, its captured steps
    through the stand-in."""
    cfg = dict(SMALL_LM, dropout=0.5)
    with capture.stand_in(cap.StandInGraph):
        res = smoke.word_lm_run(mt.cpu(), cfg=cfg, warmup=2, steps=3)
    assert res["captured"]["counts"]["graph_replays"] > 0
    assert res["eager"]["counts"]["graph_replays"] == 0
    for mode in ("captured", "eager"):
        assert np.isfinite(res[mode]["loss"])


def test_chip_smoke_parity_phase_on_the_cpu():
    """Phase 25's runs at a small size, the CPU against itself (every
    difference 0) with the steps captured through the stand-in."""
    ptb = dict(vocab=20, hidden=6, embed=5, layers=2, batch=3,
               buckets=(3, 6))
    with capture.stand_in(cap.StandInGraph):
        res = smoke.rnn_parity(mt.cpu(), mt.cpu(), ptb=ptb, lm=SMALL_LM,
                               sentences=40)
    for name in ("ptb_cells", "ptb_fused", "word_lm"):
        for key in ("logits", "grads", "params"):
            assert res[name][key] == 0.0, (name, key)
    assert res["ptb_cells"]["captured_vs_eager"] == 0.0
