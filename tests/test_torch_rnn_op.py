"""The fused ``RNN`` op of the PyTorch package against the JAX package's
(``mxnet_tpu/ops/nn.py:491-607``), on the CPU.

The same seeded numpy inputs go through both packages' ``nd.RNN`` under
``autograd.record`` with seeded head gradients: every mode (lstm, gru,
rnn_tanh, rnn_relu), one and two layers, one and two directions, with and
without the state outputs.  fp64: outputs and gradients within 1e-12 (the
same recurrences summed in other orders; the readings are near 1e-15).
fp32: 1e-5 relative.  The op sweep (``test_utils.op_cases``, run by
``test_torch_ops_matrix_nn.py``) holds more cases in fp32.  Also held:
``test_autograd.py::test_rnn_op_grad_flows`` in this package; the
dropout between layers (``p > 0`` in training), drawn from the op's
generator as ``Dropout`` draws; symbolic shape inference and argument
names against the JAX package's; the packed layout's size.
"""
import itertools

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops.nn import rnn_param_size as ref_param_size

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.nn import rnn_param_size

FP64_TOL = dict(rtol=0, atol=1e-12)
FP32_TOL = dict(rtol=1e-5, atol=1e-6)
T, N, C, H = 6, 3, 5, 4


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    prev = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_enable_x64", prev[0])
    torch.set_num_threads(prev[1])


def rnn_inputs(mode, layers, bi, seed=0, t=T):
    rng = np.random.RandomState(seed)
    d = 2 if bi else 1
    ins = [rng.uniform(-1, 1, (t, N, C)),
           rng.uniform(-0.4, 0.4, rnn_param_size(layers, C, H, mode, bi)),
           rng.uniform(-1, 1, (layers * d, N, H))]
    if mode == "lstm":
        ins.append(rng.uniform(-1, 1, (layers * d, N, H)))
    return ins


def run_rnn(pkg, ctx, ins, dtype, head_seed=1, **attrs):
    """Outputs and the gradients of every input under seeded heads."""
    nds = [pkg.nd.array(a, ctx=ctx, dtype=dtype) for a in ins]
    for a in nds:
        a.attach_grad()
    with pkg.autograd.record():
        outs = pkg.nd.RNN(*nds, **attrs)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    rng = np.random.RandomState(head_seed)
    heads = [pkg.nd.array(rng.randn(*o.shape), ctx=ctx, dtype=dtype)
             for o in outs]
    pkg.autograd.backward(outs, heads)
    return [o.asnumpy().astype(np.float64) for o in outs] + \
        [a.grad.asnumpy().astype(np.float64) for a in nds]


CASES = list(itertools.product(("lstm", "gru", "rnn_tanh", "rnn_relu"),
                               (1, 2), (False, True)))


@pytest.mark.parametrize("mode,layers,bi", CASES,
                         ids=["%s-%dL-%s" % (m, n, "bi" if b else "uni")
                              for m, n, b in CASES])
def test_rnn_op_fp64_against_jax(mode, layers, bi):
    ins = rnn_inputs(mode, layers, bi)
    attrs = dict(state_size=H, num_layers=layers, bidirectional=bi,
                 mode=mode, state_outputs=True)
    want = run_rnn(mx, mx.cpu(), ins, "float64", **attrs)
    got = run_rnn(mt, mt.cpu(), ins, "float64", **attrs)
    assert len(got) == len(want) == (3 if mode == "lstm" else 2) + len(ins)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, err_msg="item %d" % k, **FP64_TOL)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_op_fp32_without_state_outputs(mode):
    ins = rnn_inputs(mode, 2, True, seed=3)
    attrs = dict(state_size=H, num_layers=2, bidirectional=True, mode=mode)
    want = run_rnn(mx, mx.cpu(), ins, "float32", **attrs)
    got = run_rnn(mt, mt.cpu(), ins, "float32", **attrs)
    assert len(got) == len(want) == 1 + len(ins)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **FP32_TOL)


def test_rnn_op_grad_flows():
    """``tests/test_autograd.py::test_rnn_op_grad_flows`` in this
    package, from the JAX package's seeded draws."""
    mx.random.seed(5)
    data = mx.nd.random.uniform(shape=(3, 2, 4)).asnumpy()
    params = mx.nd.random.normal(scale=0.1,
                                 shape=(rnn_param_size(1, 4, 5, "lstm"),))
    params = params.asnumpy()
    grads = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        with ctx:
            p = pkg.nd.array(params, ctx=ctx)
            p.attach_grad()
            h0 = pkg.nd.zeros((1, 2, 5), ctx=ctx)
            with pkg.autograd.record():
                out = pkg.nd.RNN(pkg.nd.array(data, ctx=ctx), p, h0, h0,
                                 state_size=5, num_layers=1, mode="lstm")
                loss = (out * out).sum()
            loss.backward()
            grads.append(p.grad.asnumpy())
    assert np.abs(grads[1]).sum() > 0
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-5, atol=1e-7)


def test_param_size_is_the_jax_packages():
    for mode, layers, bi in CASES:
        for c in (1, 7):
            assert rnn_param_size(layers, c, 9, mode, bi) == \
                ref_param_size(layers, c, 9, mode, bi)


def test_symbolic_rnn_matches_jax():
    """Argument names, inferred shapes and output count of ``sym.RNN``
    against the JAX package's, for every mode and ``state_outputs``."""
    for mode, states in itertools.product(("lstm", "gru", "rnn_relu"),
                                          (False, True)):
        got = []
        for pkg in (mx, mt):
            with pkg.name.NameManager():
                r = pkg.sym.RNN(pkg.sym.var("data"), state_size=H,
                                num_layers=2, bidirectional=True, mode=mode,
                                state_outputs=states, name="r")
            got.append((r.list_arguments(), r.list_outputs(),
                        r.infer_shape(data=(T, N, C))))
        assert got[0] == got[1]


def dropout_run(p, train, seed, layers=3):
    """The 3-layer LSTM op from seeded inputs with generator ``seed``: its
    output and the gradient of the output's sum at the parameters."""
    gen = torch.Generator().manual_seed(seed)
    ins = [torch.tensor(a) for a in rnn_inputs("lstm", layers, False, 2)]
    ins[1].requires_grad_(True)
    op = mt.ops.registry.get_op("RNN")
    with torch.enable_grad():
        out = op.apply(ins, dict(state_size=H, num_layers=layers,
                                 mode="lstm", p=p),
                       train_mode=train, rng=gen)[0]
        grad, = torch.autograd.grad(out.sum(), ins[1])
    return out.detach(), grad, ins


def test_rnn_dropout_between_layers():
    """``p > 0`` in training: one layer a call, the mask of ``Dropout``
    drawn from the op's generator between the layers and not after the
    last, and the gradient through it; the same generator state draws
    the same masks; in predict mode the op is the dropout-free one."""
    out, grad, ins = dropout_run(0.5, True, seed=7)
    again, _, _ = dropout_run(0.5, True, seed=7)
    other, _, _ = dropout_run(0.5, True, seed=8)
    plain, _, _ = dropout_run(0.0, True, seed=7)
    predict, _, _ = dropout_run(0.5, False, seed=7)
    assert torch.equal(out, again) and not torch.equal(out, other)
    assert torch.equal(predict, plain) and not torch.equal(out, plain)
    # by hand: a one-layer op per layer, Dropout's own draw between
    gen = torch.Generator().manual_seed(7)
    rnn, drop = (mt.ops.registry.get_op(n) for n in ("RNN", "Dropout"))
    params = ins[1].detach().requires_grad_(True)
    with torch.enable_grad():
        x, at = ins[0], 0
        for layer in range(3):
            size = rnn_param_size(1, x.shape[2], H, "lstm")
            x = rnn.apply([x, params[at:at + size], ins[2][layer:layer + 1],
                           ins[3][layer:layer + 1]],
                          dict(state_size=H, num_layers=1, mode="lstm"))[0]
            at += size
            if layer < 2:
                x = drop.apply([x], {"p": 0.5}, train_mode=True, rng=gen)[0]
        by_hand, = torch.autograd.grad(x.sum(), params)
    assert torch.equal(out, x.detach())
    np.testing.assert_allclose(grad.numpy(), by_hand.numpy(), **FP64_TOL)


def test_rnn_without_generator_in_training_raises():
    ins = [torch.tensor(a) for a in rnn_inputs("gru", 2, False)]
    with pytest.raises(mt.MXNetError):
        mt.ops.registry.get_op("RNN").apply(
            ins, dict(state_size=H, num_layers=2, mode="gru", p=0.3),
            train_mode=True, rng=None)


def test_packed_size_mismatch_raises():
    ins = [torch.tensor(a) for a in rnn_inputs("lstm", 1, False)]
    ins[1] = ins[1][:-1]
    with pytest.raises(mt.MXNetError):
        mt.ops.registry.get_op("RNN").apply(
            ins, dict(state_size=H, num_layers=1, mode="lstm"))
