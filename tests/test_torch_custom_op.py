"""``Custom`` ops and ``operator`` against the JAX package on the CPU.

``tests/test_custom_op.py`` case for case: the same props (a sigmoid, and
``example/numpy-ops``' two-input numpy softmax) registered in both
packages, each case run in both, the reference's own assertions held for
the port and the port's results equal to the JAX package's within 1e-6
(the same numpy callbacks; the small net's products in other orders).
Then the port's own: a hybridized block and a ``Module`` step whose
graph holds a ``Custom`` node run eagerly where they would be captured,
counted in ``host_op_programs`` (driven under a stand-in graph class);
auxiliary states reach the callbacks read-only with a warning; a Symbol
holding the op takes its argument names from the prop and infers its
shapes from the prop's ``infer_shape``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import capture, profiler

PARITY = dict(rtol=1e-6, atol=1e-6)


def _sigmoid_classes(pkg):
    class Sigmoid(pkg.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            y = 1.0 / (1.0 + np.exp(-in_data[0].asnumpy()))
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            g = out_grad[0].asnumpy() * y * (1.0 - y)
            self.assign(in_grad[0], req[0], g)

    @pkg.operator.register("t_sigmoid")
    class SigmoidProp(pkg.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    class NumpySoftmax(pkg.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0], e / e.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lbl = in_data[1].asnumpy().ravel().astype(np.int64)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lbl.shape[0]), lbl] -= 1.0
            self.assign(in_grad[0], req[0], y)

    @pkg.operator.register("t_numpy_softmax")
    class NumpySoftmaxProp(pkg.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return NumpySoftmax()


_sigmoid_classes(mx)
_sigmoid_classes(mt)


def both(fn):
    with mx.cpu():
        want = fn(mx)
    with mt.cpu():
        got = fn(mt)
    return want, got


def test_custom_registered():
    want, got = both(lambda p: p.operator.get_all_registered_operators())
    assert "t_sigmoid" in got and set(want) <= set(got)


def test_custom_forward_eager():
    x = np.array([[0.0, 1.0], [-1.0, 2.0]], np.float32)
    want, got = both(lambda p: p.nd.Custom(p.nd.array(x),
                                           op_type="t_sigmoid").asnumpy())
    np.testing.assert_allclose(got, 1.0 / (1.0 + np.exp(-x)), rtol=1e-6)
    np.testing.assert_allclose(got, want, **PARITY)


def test_custom_backward():
    x0 = np.array([[0.5, -0.25]], np.float32)

    def run(p):
        x = p.nd.array(x0)
        x.attach_grad()
        with p.autograd.record():
            loss = p.nd.Custom(x, op_type="t_sigmoid").sum()
        loss.backward()
        return x.grad.asnumpy()
    want, got = both(run)
    s = 1.0 / (1.0 + np.exp(-x0))
    np.testing.assert_allclose(got, s * (1 - s), rtol=1e-5)
    np.testing.assert_allclose(got, want, **PARITY)


def test_custom_softmax_two_inputs():
    x0 = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    lbl = np.array([0, 1, 2, 3], np.float32)

    def run(p):
        data, label = p.nd.array(x0), p.nd.array(lbl)
        out = p.nd.Custom(data, label, op_type="t_numpy_softmax").asnumpy()
        data.attach_grad()
        with p.autograd.record():
            y = p.nd.Custom(data, label, op_type="t_numpy_softmax")
        y.backward()
        return out, data.grad.asnumpy()
    (w_out, w_grad), (out, grad) = both(run)
    np.testing.assert_allclose(out.sum(axis=1), np.ones(4), rtol=1e-5)
    expect = out.copy()
    expect[np.arange(4), lbl.astype(np.int64)] -= 1.0
    np.testing.assert_allclose(grad, expect, rtol=1e-5)
    np.testing.assert_allclose(out, w_out, **PARITY)
    np.testing.assert_allclose(grad, w_grad, **PARITY)


def test_custom_in_symbol():
    x = np.array([[0.0, 1.0]], np.float32)

    def run(p):
        sym_y = p.sym.Custom(p.sym.Variable("data"), op_type="t_sigmoid",
                             name="sig")
        exe = sym_y.bind(p.cpu(), {"data": p.nd.array(x)})
        return exe.forward()[0].asnumpy()
    want, got = both(run)
    np.testing.assert_allclose(got, 1.0 / (1.0 + np.exp(-x)), rtol=1e-6)
    np.testing.assert_allclose(got, want, **PARITY)


def test_custom_train_small_net():
    """A tiny net with a Custom head trains (the numpy-ops demo's point),
    the same losses in both packages."""
    def run(p):
        rng = np.random.RandomState(0)
        w = p.nd.array(rng.randn(3, 4).astype(np.float32) * 0.1)
        w.attach_grad()
        data = p.nd.array(rng.randn(8, 3).astype(np.float32))
        label = p.nd.array(rng.randint(0, 4, (8,)).astype(np.float32))
        losses = []
        for _ in range(5):
            with p.autograd.record():
                prob = p.nd.Custom(p.nd.dot(data, w), label,
                                   op_type="t_numpy_softmax")
            prob.backward()
            idx = label.asnumpy().astype(np.int64)
            losses.append(-np.log(prob.asnumpy()[np.arange(8), idx]
                                  + 1e-9).mean())
            w -= 0.5 * w.grad
            w.grad[:] = 0
        return losses
    want, got = both(run)
    assert got[-1] < got[0], got
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- the port's own ----------------------------------------------------------
class _StandIn:
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


def _counts():
    names = ("graph_captures", "graph_replays", "program_calls",
             "host_op_programs")
    return {n: profiler.counter(n) for n in names}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


def test_hybridized_block_with_custom_runs_eagerly():
    """Where its call would be captured (a stand-in graph class here, the
    card's CUDA graphs there), a hybridized block whose graph holds a
    Custom op runs eagerly, one ``host_op_programs`` a call, and its
    gradient is the one the unhybridized block gives."""
    nn = mt.gluon.nn

    class Head(mt.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = nn.Dense(3, in_units=2)

        def hybrid_forward(self, F, x):
            return F.Custom(self.dense(x), op_type="t_sigmoid")

    x = np.random.RandomState(1).randn(4, 2).astype(np.float32)
    grads = []
    with mt.cpu(), mt.name.NameManager(), capture.stand_in(_StandIn):
        for hybrid in (False, True):
            net = Head(prefix="head_")
            mt.random.seed(0)
            net.initialize(mt.init.Xavier())
            if hybrid:
                net.hybridize()
            for _ in range(2):
                before = _counts()
                with mt.autograd.record():
                    out = net(mt.nd.array(x))
                out.backward()
                if hybrid:
                    assert _delta(before) == dict(
                        graph_captures=0, graph_replays=0, program_calls=0,
                        host_op_programs=1)
            grads.append(net.dense.weight.grad().asnumpy())
    np.testing.assert_array_equal(grads[0], grads[1])


def test_module_step_with_custom_head_runs_eagerly():
    """``examples/numpy_ops_softmax.py``'s net through ``Module``: the
    fused step runs eagerly (one ``host_op_programs`` and one
    ``program_calls`` a step, no capture) and the loss falls."""
    S = mt.sym
    data, lab = S.Variable("data"), S.Variable("softmax_label")
    hid = S.Activation(S.FullyConnected(data, num_hidden=32, name="fc1"),
                       act_type="relu")
    net = S.Custom(S.FullyConnected(hid, num_hidden=4, name="fc2"), lab,
                   op_type="t_numpy_softmax", name="softmax")
    assert net.list_arguments() == ["data", "fc1_weight", "fc1_bias",
                                    "fc2_weight", "fc2_bias",
                                    "softmax_label"]
    rng = np.random.RandomState(2)
    xs = rng.randn(64, 6).astype(np.float32)
    ys = (xs[:, :4].argmax(axis=1)).astype(np.float32)
    with mt.cpu(), capture.stand_in(_StandIn):
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.bind([mt.io.DataDesc("data", (16, 6))],
                 [mt.io.DataDesc("softmax_label", (16,))])
        mt.random.seed(0)
        mod.init_params(mt.init.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.5),))
        losses = []
        for epoch in range(4):
            for i in range(0, 64, 16):
                before = _counts()
                batch = mt.io.DataBatch([mt.nd.array(xs[i:i + 16])],
                                        [mt.nd.array(ys[i:i + 16])])
                mod._fit_step(batch)
                assert _delta(before) == dict(
                    graph_captures=0, graph_replays=0, program_calls=1,
                    host_op_programs=1)
                prob = mod.get_outputs()[0].asnumpy()
                losses.append(-np.log(prob[np.arange(16), ys[i:i + 16]
                                           .astype(np.int64)]).mean())
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_aux_states_are_read_only_with_a_warning():
    class Scale(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        in_data[0].asnumpy() * aux[0].asnumpy())
            aux[0][:] = 0.0

    @mt.operator.register("t_aux_scale")
    class ScaleProp(mt.operator.CustomOpProp):
        def list_auxiliary_states(self):
            return ["scale"]

        def create_operator(self, ctx, shapes, dtypes):
            return Scale()

    with mt.cpu():
        x = mt.nd.array(np.arange(4, dtype=np.float32))
        aux = mt.nd.array(np.full(4, 2.0, np.float32))
        with pytest.warns(UserWarning, match="read-only"):
            y = mt.nd.Custom(x, aux, op_type="t_aux_scale")
        np.testing.assert_array_equal(y.asnumpy(), [0.0, 2.0, 4.0, 6.0])
        np.testing.assert_array_equal(aux.asnumpy(), [2.0] * 4)


def test_symbol_shapes_come_from_the_prop():
    S = mt.sym
    net = S.Custom(S.Variable("data"), S.Variable("label"),
                   op_type="t_numpy_softmax", name="sm")
    args, outs, auxs = net.infer_shape(data=(5, 7), label=(5,))
    assert [tuple(a) for a in args] == [(5, 7), (5,)]
    assert [tuple(o) for o in outs] == [(5, 7)] and auxs == []
    with pytest.raises(mt.MXNetError):
        with mt.cpu():
            mt.nd.Custom(mt.nd.zeros((2, 2)), op_type="no_such_op")
