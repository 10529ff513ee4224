"""Symbol and Executor of the PyTorch package against the JAX package:
shape and type inference of the full-width MNIST MLP, and ``simple_bind``
forward/backward through the registered ``pl_scale`` with the JAX
package's parameters carried across by ``params_from_jax`` (fp32, CPU)."""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd, sym, rtc
from mxnet_tpu_torch.ops import scale as sc

# outputs and gradients of the same fp32 graph, summed in other orders
ATOL = 1e-5
BATCH = 64


def _scale_grad(og, ins, outs, attrs):
    return (og[0] * float(attrs.get("alpha", 2.0)),)


def _port_scale(x, alpha=2.0, interpret=False):
    return sc.scale_reference(x, alpha) if interpret else sc.scale(x, alpha)


def _jax_scale(x, alpha=2.0, interpret=False):
    import functools
    import jax
    from jax.experimental import pallas as pl

    def body(x_ref, o_ref, *, alpha):
        o_ref[...] = x_ref[...] * alpha
    return pl.pallas_call(functools.partial(body, alpha=float(alpha)),
                          out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                          interpret=bool(interpret))(x)


@pytest.fixture
def kernels():
    """``pl_scale`` registered in both packages, removed afterwards."""
    rtc.register("pl_scale", _port_scale, grad=_scale_grad, force=True)
    mx.pallas.register("pl_scale", _jax_scale, grad=_scale_grad, force=True)
    yield
    rtc.unregister("pl_scale")
    mx.pallas.unregister("pl_scale")


def build_mlp(S):
    """``examples/train_mnist.py::build_mlp`` (784-128-64-10) with the
    registered kernel after the first activation."""
    net = S.Flatten(S.Variable("data"))
    net = S.FullyConnected(net, num_hidden=128, name="fc1")
    net = S.Activation(net, act_type="relu")
    net = S.pl_scale(net, alpha=0.5)
    net = S.FullyConnected(net, num_hidden=64, name="fc2")
    net = S.Activation(net, act_type="relu")
    net = S.FullyConnected(net, num_hidden=10, name="fc3")
    return S.SoftmaxOutput(net, name="softmax")


def _batch(seed=0):
    blob = mt.test_utils.get_mnist()
    x = blob["train_data"][:BATCH].reshape(BATCH, -1)
    return x, blob["train_label"][:BATCH]


def _bound_pair(grad_req="write"):
    """The MLP bound in both packages with the same Xavier parameters."""
    jexe = build_mlp(mx.sym).simple_bind(mx.cpu(), grad_req=grad_req,
                                         data=(BATCH, 784),
                                         softmax_label=(BATCH,))
    init = mx.init.Xavier()
    params = [n for n in jexe.arg_names if n not in ("data", "softmax_label")]
    for n in params:
        init(mx.init.InitDesc(n), jexe.arg_dict[n])
    exe = build_mlp(sym).simple_bind(mt.cpu(), grad_req=grad_req,
                                     data=(BATCH, 784),
                                     softmax_label=(BATCH,))
    exe.copy_params_from(nd.params_from_jax(
        {n: jexe.arg_dict[n].asnumpy() for n in params}, exe))
    return exe, jexe, params


def test_infer_shape_and_type_match_jax(kernels):
    net, jnet = build_mlp(sym), build_mlp(mx.sym)
    assert net.list_arguments() == jnet.list_arguments() == [
        "data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias",
        "fc3_weight", "fc3_bias", "softmax_label"]
    assert net.list_outputs() == jnet.list_outputs()
    assert net.list_auxiliary_states() == jnet.list_auxiliary_states() == []
    shapes = net.infer_shape(data=(BATCH, 784))
    assert shapes == jnet.infer_shape(data=(BATCH, 784))
    assert shapes[1] == [(BATCH, 10)]
    assert net.infer_type(data=np.float32) == jnet.infer_type(
        data=np.float32)
    partial = net.infer_shape_partial(data=(BATCH, 784))
    assert partial == jnet.infer_shape_partial(data=(BATCH, 784))


def test_forward_backward_match_jax(kernels):
    exe, jexe, params = _bound_pair()
    x, y = _batch()
    for e in (exe, jexe):
        e.forward(is_train=True, data=x, softmax_label=y)
        e.backward()
    np.testing.assert_allclose(exe.outputs[0].asnumpy(),
                               jexe.outputs[0].asnumpy(), atol=ATOL)
    assert list(exe.output_dict) == ["softmax_output"]
    for n in exe.arg_names:
        np.testing.assert_allclose(exe.grad_dict[n].asnumpy(),
                                   jexe.grad_dict[n].asnumpy(), atol=ATOL,
                                   err_msg=n)
    assert not exe.grad_dict["softmax_label"].asnumpy().any()
    # eval forward, and forward_backward in one call
    np.testing.assert_allclose(exe.forward(data=x)[0].asnumpy(),
                               jexe.forward(data=x)[0].asnumpy(), atol=ATOL)
    exe.forward_backward()
    np.testing.assert_allclose(exe.grad_dict["fc1_weight"].asnumpy(),
                               jexe.grad_dict["fc1_weight"].asnumpy(),
                               atol=ATOL)


def test_grads_written_in_place_and_grad_req(kernels):
    reqs = {"data": "null", "fc1_weight": "add", "softmax_label": "null"}
    exe, jexe, params = _bound_pair(grad_req=dict(
        reqs, **{n: reqs.get(n, "write") for n in
                 ("fc1_bias", "fc2_weight", "fc2_bias", "fc3_weight",
                  "fc3_bias")}))
    assert exe.grad_dict["data"] is None
    held = {n: exe.grad_dict[n] for n in params}
    ptrs = {n: a._data.data_ptr() for n, a in held.items()}
    x, y = _batch()
    for _ in range(2):
        for e in (exe, jexe):
            e.forward(is_train=True, data=x, softmax_label=y)
            e.backward()
    for n in params:
        assert exe.grad_dict[n] is held[n]
        assert held[n]._data.data_ptr() == ptrs[n]
        np.testing.assert_allclose(held[n].asnumpy(),
                                   jexe.grad_dict[n].asnumpy(), atol=ATOL,
                                   err_msg=n)


def test_explicit_out_grads_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 4).astype(np.float32)
    w = rng.randn(2, 4).astype(np.float32)
    head = rng.randn(3, 2).astype(np.float32)
    got = []
    for S, ndm, ctx in ((sym, nd, mt.cpu()), (mx.sym, mx.nd, mx.cpu())):
        net = S.FullyConnected(S.Variable("x"), S.Variable("w"),
                               num_hidden=2, no_bias=True) * 3.0
        ex = net.bind(ctx, {"x": ndm.array(x, ctx=ctx),
                            "w": ndm.array(w, ctx=ctx)})
        ex.forward(is_train=True)
        ex.backward(ndm.array(head, ctx=ctx))
        got.append((ex.outputs[0].asnumpy(), ex.grad_dict["w"].asnumpy(),
                    ex.grad_dict["x"].asnumpy()))
    for a, b in zip(*got):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=ATOL)


def test_binding_errors(kernels):
    net = build_mlp(sym)
    with pytest.raises(mt.MXNetError, match="missing arguments"):
        net.bind(mt.cpu(), {"data": nd.zeros((2, 784), ctx=mt.cpu())})
    with pytest.raises(mt.MXNetError, match="cannot infer"):
        net.simple_bind(mt.cpu())
    exe = net.simple_bind(mt.cpu(), data=(BATCH, 784))
    with pytest.raises(mt.MXNetError, match="before forward"):
        exe.backward()
    with pytest.raises(mt.MXNetError, match="unknown argument"):
        exe.forward(nothing=np.zeros(1))
    with pytest.raises(mt.MXNetError, match="not an argument"):
        nd.params_from_jax({"fc9_weight": np.zeros((1, 1), np.float32)}, exe)
    with pytest.raises(mt.MXNetError, match="shape"):
        nd.params_from_jax({"fc1_weight": np.zeros((1, 1), np.float32)}, exe)
    with pytest.raises(mt.MXNetError, match="dtype"):
        nd.params_from_jax({"fc1_bias": np.zeros(128, np.float64)}, exe)


def test_group_selection_and_operators_match_jax():
    got = []
    for S, ndm, ctx in ((sym, nd, mt.cpu()), (mx.sym, mx.nd, mx.cpu())):
        a, b = S.Variable("a"), S.Variable("b")
        g = S.Group([a * b + 1.0, (a - b) / 2.0, -a, 2.0 - b])
        assert len(g) == 4 and g[1:3].num_outputs == 2
        net = S.Group([g[g.list_outputs()[0]], g[1], g[2:4]])
        ex = net.bind(ctx, {"a": ndm.array(np.array([1.0, 2.0]), ctx=ctx),
                            "b": ndm.array(np.array([3.0, 5.0]), ctx=ctx)},
                      grad_req="null")
        got.append([o.asnumpy() for o in ex.forward()])
        with pytest.raises((mt.MXNetError, mx.MXNetError)):
            S.FullyConnected(g, num_hidden=2)
    for a, b in zip(*got):
        np.testing.assert_allclose(a, b, rtol=1e-6)
