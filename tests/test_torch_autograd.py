"""Autograd of the PyTorch package against the JAX package's tape: record,
attach_grad, backward with grad_req write/add/null, and SoftmaxOutput's
semantic gradient (fp32, on the CPU, same numpy inputs)."""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd

# gradients of the same fp32 expressions, summed in other orders
ATOL = 1e-5


def _graph(pkg, x, w, b):
    """y = sum(relu(FC(x; w, b)) * x_scaled) with a reshape and a scalar op
    on the way, recorded in package ``pkg`` (``nd`` module and its
    ``autograd``)."""
    ndm, ag = pkg
    with ag.record():
        h = ndm.FullyConnected(x, w, b, num_hidden=w.shape[0])
        h = ndm.Activation(h, act_type="tanh") * 2.0 + h.relu()
        h = (h.reshape((-1,)) - 0.5) / 3.0
        y = h.sum()
    return y


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(4, 6).astype(np.float32),
            rng.randn(5, 6).astype(np.float32),
            rng.randn(5).astype(np.float32))


def _run(pkg, arrays, reqs, steps):
    ndm, ag = pkg
    x, w, b = arrays
    for a, req in zip(arrays, reqs):
        a.attach_grad(grad_req=req)
    for _ in range(steps):
        _graph(pkg, x, w, b).backward()
    return [a.grad.asnumpy() for a in arrays]


@pytest.mark.parametrize("reqs,steps", [
    (("write", "write", "write"), 1), (("write", "write", "write"), 2),
    (("add", "add", "write"), 2), (("null", "write", "add"), 3)])
def test_backward_matches_jax(reqs, steps):
    vals = _inputs(sum(map(len, reqs)) + steps)
    got = _run((nd, mt.autograd), [nd.array(v, ctx=mt.cpu()) for v in vals],
               reqs, steps)
    want = _run((jnd, mx.autograd), [jnd.array(v) for v in vals], reqs,
                steps)
    for g, w, req in zip(got, want, reqs):
        if req == "null":
            assert not g.any() and not w.any()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=ATOL)


def test_head_gradient_and_retain_graph():
    vals = _inputs(9)
    head = np.random.RandomState(10).randn(4, 5).astype(np.float32)
    out = []
    for ndm, ag, ctx in ((nd, mt.autograd, mt.cpu()),
                         (jnd, mx.autograd, mx.cpu())):
        x, w, b = (ndm.array(v, ctx=ctx) for v in vals)
        w.attach_grad(grad_req="add")
        with ag.record():
            y = ndm.FullyConnected(x, w, b, num_hidden=5) * x.sum()
        y.backward(ndm.array(head, ctx=ctx), retain_graph=True)
        y.backward(ndm.array(head, ctx=ctx))
        out.append(w.grad.asnumpy())
    np.testing.assert_allclose(out[0], out[1], rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("attrs", [
    {}, {"normalization": "batch"}, {"normalization": "valid",
                                     "use_ignore": True, "ignore_label": 2},
    {"grad_scale": 0.25, "smooth_alpha": 0.1}, {"use_ignore": True},
    {"multi_output": True}, {"dense_label": True}])
def test_softmax_output_semantic_gradient_matches_jax(attrs):
    attrs = dict(attrs)
    rng = np.random.RandomState(11)
    multi = attrs.get("multi_output", False)
    shape = (4, 5, 3) if multi else (6, 5)
    data = rng.randn(*shape).astype(np.float32)
    if attrs.pop("dense_label", False):
        label = rng.dirichlet(np.ones(5), 6).astype(np.float32)
    else:
        label = rng.randint(0, 5, (4, 3) if multi else (6,)).astype(
            np.float32)
    head = rng.randn(*shape).astype(np.float32)  # ignored by SoftmaxOutput
    grads = []
    for ndm, ag, ctx in ((nd, mt.autograd, mt.cpu()),
                         (jnd, mx.autograd, mx.cpu())):
        d, lab = ndm.array(data, ctx=ctx), ndm.array(label, ctx=ctx)
        d.attach_grad()
        lab.attach_grad()
        with ag.record():
            out = ndm.SoftmaxOutput(d, lab, **attrs)
        out.backward(ndm.array(head, ctx=ctx))
        grads.append((out.asnumpy(), d.grad.asnumpy(), lab.grad.asnumpy()))
    for got, want in zip(grads[0], grads[1]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
    assert not grads[0][2].any()  # the label gets no gradient


def test_scopes_and_flags():
    ag = mt.autograd
    assert not ag.is_recording() and not ag.is_training()
    with ag.record():
        assert ag.is_recording() and ag.is_training()
        with ag.pause():
            assert not ag.is_recording() and not ag.is_training()
        with ag.predict_mode():
            assert ag.is_recording() and not ag.is_training()
    with ag.record(train_mode=False):
        assert not ag.is_training()
    with ag.train_mode():
        assert ag.is_training() and not ag.is_recording()
    assert not ag.is_recording() and not ag.is_training()


def test_paused_ops_are_not_differentiated():
    x = nd.array([1.0, 2.0], ctx=mt.cpu())
    x.attach_grad()
    with mt.autograd.record():
        y = x * 3.0
        with mt.autograd.pause():
            z = x * 5.0
        (y + z).sum().backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), [3.0, 3.0])


def test_mark_variables_and_head_outside_graph():
    x = nd.array([1.0, 2.0], ctx=mt.cpu())
    g = nd.zeros((2,), ctx=mt.cpu())
    mt.autograd.mark_variables([x], [g])
    with mt.autograd.record():
        y = (x * x).sum()
    y.backward()
    np.testing.assert_array_equal(g.asnumpy(), [2.0, 4.0])
    assert x.grad is g
    with pytest.raises(mt.MXNetError, match="recorded"):
        nd.array([1.0], ctx=mt.cpu()).backward()
    with pytest.raises(mt.MXNetError, match="grad_req"):
        x.attach_grad(grad_req="sometimes")
