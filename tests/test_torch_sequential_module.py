"""``SequentialModule``, ``PythonModule`` and ``PythonLossModule`` of the
PyTorch package against the JAX package on the CPU.

- ``tests/test_module.py::test_sequential_module_trains`` and
  ``::test_python_loss_module_chain``, case for case.
- A two-stage chain (Dense + tanh, then Dense + SoftmaxOutput), bound
  with ``inputs_need_grad``, from the same parameters as the JAX
  package's, 3 SGD steps (momentum, wd): each step's outputs and input
  gradients and the parameters after it, in fp64 within 1e-10 and in
  fp32 within rtol 1e-5 / atol 1e-6.  The JAX package binds every stage
  after the first at float32 whatever the data's dtype (``DataDesc``'s
  default); its fp64 chain here binds its stages at fp64, as the port's
  does by itself.
- The chain against one port ``Module`` of the same graph in fp64
  within 1e-12.
- ``PythonModule``'s names, shapes and bound state against the JAX
  package's; ``PythonLossModule``'s ``grad_func`` gets NDArrays on the
  module's context and its gradient lands there.
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx

import mxnet_tpu_torch as mt

STEPS, BATCH, IN, HID, OUT = 3, 8, 6, 5, 3
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
TOL = {"float64": dict(rtol=0, atol=1e-10),
       "float32": dict(rtol=1e-5, atol=1e-6)}


@pytest.fixture(scope="module", autouse=True)
def x64():
    """The JAX package turns x64 on at import; another test may have
    turned it off in this worker."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _ctx(pkg):
    return pkg.cpu()


# -- the reference's cases ------------------------------------------------
def _blob3():
    np.random.seed(0)
    X = np.random.randn(64, 8).astype(np.float32)
    Y = np.random.randint(0, 3, 64).astype(np.float32)
    X[np.arange(64), Y.astype(int)] += 2.5
    return X, Y


def test_sequential_module_trains():
    """The reference's two symbol stages, fit 12 epochs: accuracy above
    0.8 (``tests/test_module.py:164``)."""
    X, Y = _blob3()
    with mt.cpu():
        it = mt.io.NDArrayIter(X, Y, batch_size=16)
        stage1 = mt.sym.Activation(mt.sym.FullyConnected(
            mt.sym.Variable("data"), num_hidden=16, name="s1fc"),
            act_type="tanh")
        stage2 = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
            mt.sym.Variable("data"), num_hidden=3, name="s2fc"),
            name="softmax")
        seq = mt.mod.SequentialModule()
        seq.add(mt.mod.Module(stage1, label_names=()), auto_wiring=True)
        seq.add(mt.mod.Module(stage2), take_labels=True)
        seq.fit(it, num_epoch=12, optimizer="sgd",
                initializer=mt.init.Xavier(),
                optimizer_params={"learning_rate": 0.2})
        acc = seq.score(mt.io.NDArrayIter(X, Y, batch_size=16),
                        "acc")[0][1]
    assert acc > 0.8, acc


def _softmax_grad(pkg):
    def grad(scores, labels):
        s = scores.asnumpy()
        e = np.exp(s - s.max(axis=1, keepdims=True))
        p = e / e.sum(axis=1, keepdims=True)
        p[np.arange(p.shape[0]), labels.asnumpy().astype(np.int64)] -= 1.0
        return pkg.nd.array(p / p.shape[0])
    return grad


def test_python_loss_module_chain():
    """A PythonLossModule ends the chain with a hand-written softmax
    gradient; the logits' argmax reaches accuracy above 0.8
    (``tests/test_module.py:192``)."""
    np.random.seed(1)
    X = np.random.randn(32, 6).astype(np.float32)
    Y = np.random.randint(0, 2, 32).astype(np.float32)
    X[:, 0] += (Y * 2 - 1) * 2.0
    with mt.cpu():
        it = mt.io.NDArrayIter(X, Y, batch_size=8)
        logits = mt.sym.FullyConnected(mt.sym.Variable("data"),
                                       num_hidden=2, name="fc")
        seq = mt.mod.SequentialModule()
        seq.add(mt.mod.Module(logits, label_names=()), auto_wiring=True)
        seq.add(mt.mod.PythonLossModule(grad_func=_softmax_grad(mt)),
                take_labels=True)
        seq.fit(it, num_epoch=8, optimizer="sgd",
                optimizer_params={"learning_rate": 0.5})
        out = []
        it.reset()
        for batch in it:
            seq.forward(batch, is_train=False)
            out.append(seq.get_outputs()[0].asnumpy())
    acc = (np.concatenate(out).argmax(axis=1) == Y).mean()
    assert acc > 0.8, acc


# -- a two-stage chain against the JAX package -----------------------------
def _stages(pkg):
    s1 = pkg.sym.Activation(pkg.sym.FullyConnected(
        pkg.sym.Variable("data"), num_hidden=HID, name="c1"),
        act_type="tanh")
    s2 = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        pkg.sym.Variable("data"), num_hidden=OUT, name="c2"),
        name="softmax")
    return s1, s2


def _init(dtype):
    rng = np.random.RandomState(23)
    return {"c1_weight": rng.randn(HID, IN) * 0.5,
            "c1_bias": rng.randn(HID) * 0.1,
            "c2_weight": rng.randn(OUT, HID) * 0.5,
            "c2_bias": rng.randn(OUT) * 0.1}


def _data(dtype):
    rng = np.random.RandomState(24)
    return [(rng.randn(BATCH, IN).astype(dtype),
             rng.randint(0, OUT, BATCH).astype(dtype))
            for _ in range(STEPS)]


def _at_dtype(bind, dtype):
    """``bind`` with every DataDesc at ``dtype`` (the JAX package's chain
    binds its later stages at float32)."""
    def wrapped(data_shapes, label_shapes=None, **kw):
        def fix(descs):
            return None if descs is None else [
                mx.io.DataDesc(d[0], d[1], dtype=dtype) for d in descs]
        return bind(fix(data_shapes), fix(label_shapes), **kw)
    return wrapped


def _chain(pkg, dtype):
    s1, s2 = _stages(pkg)
    ctx = _ctx(pkg)
    first = pkg.mod.Module(s1, label_names=(), context=ctx)
    second = pkg.mod.Module(s2, context=ctx)
    if pkg is mx:
        for m in (first, second):
            m.bind = _at_dtype(m.bind, dtype)
    seq = pkg.mod.SequentialModule()
    seq.add(first, auto_wiring=True)
    seq.add(second, take_labels=True)
    seq.bind([pkg.io.DataDesc("data", (BATCH, IN), dtype=dtype)],
             [pkg.io.DataDesc("softmax_label", (BATCH,), dtype=dtype)],
             inputs_need_grad=True)
    params = {k: pkg.nd.array(v.astype(dtype), ctx=ctx, dtype=dtype)
              for k, v in _init(dtype).items()}
    seq.init_params(arg_params=params, aux_params={})
    seq.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    return seq


def _run(pkg, mod, dtype):
    """STEPS training steps: [(outputs, input gradients, params)]."""
    ctx = _ctx(pkg)
    record = []
    for x, y in _data(dtype):
        batch = pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx, dtype=dtype)],
                                 [pkg.nd.array(y, ctx=ctx, dtype=dtype)])
        mod.forward(batch, is_train=True)
        mod.backward()
        out = mod.get_outputs()[0].asnumpy().copy()
        grad = mod.get_input_grads()[0].asnumpy().copy()
        mod.update()
        arg, _ = mod.get_params()
        record.append((out, grad, {k: v.asnumpy().copy()
                                   for k, v in arg.items()}))
    return record


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chain_matches_jax(dtype):
    with mt.cpu():
        port = _run(mt, _chain(mt, dtype), dtype)
    ref = _run(mx, _chain(mx, dtype), dtype)
    for (po, pg, pp), (ro, rg, rp) in zip(port, ref):
        assert po.dtype == ro.dtype == np.dtype(dtype)
        np.testing.assert_allclose(po, ro, **TOL[dtype])
        np.testing.assert_allclose(pg, rg, **TOL[dtype])
        assert sorted(pp) == sorted(rp)
        for k in rp:
            np.testing.assert_allclose(pp[k], rp[k], **TOL[dtype])


def test_chain_matches_one_module():
    """The chain and one Module of the whole graph, fp64: 1e-12."""
    dtype = "float64"
    with mt.cpu():
        chain = _run(mt, _chain(mt, dtype), dtype)
        s1, _ = _stages(mt)
        whole = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
            s1, num_hidden=OUT, name="c2"), name="softmax")
        mod = mt.mod.Module(whole, context=mt.cpu())
        mod.bind([mt.io.DataDesc("data", (BATCH, IN), dtype=dtype)],
                 [mt.io.DataDesc("softmax_label", (BATCH,), dtype=dtype)],
                 inputs_need_grad=True)
        mod.init_params(arg_params={
            k: mt.nd.array(v, ctx=mt.cpu(), dtype=dtype)
            for k, v in _init(dtype).items()}, aux_params={})
        mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
        single = _run(mt, mod, dtype)
    for (co, cg, cp), (so, sg, sp) in zip(chain, single):
        np.testing.assert_allclose(co, so, rtol=0, atol=1e-12)
        np.testing.assert_allclose(cg, sg, rtol=0, atol=1e-12)
        for k in sp:
            np.testing.assert_allclose(cp[k], sp[k], rtol=0, atol=1e-12)


def test_later_stages_bind_at_the_outputs_dtype():
    with mt.cpu():
        seq = _chain(mt, "float64")
    for m in seq._modules:
        ex = m._exec_group.execs[0]
        assert all(a._data.dtype == torch.float64
                   for a in ex.arg_dict.values())
    assert seq._modules[1]._exec_group.grad_req["data"] == "write"
    assert seq._modules[0]._exec_group.grad_req["data"] == "write"


def test_chain_members_take_the_two_call_path():
    """No member builds ``Module``'s one-call step inside a chain."""
    with mt.cpu():
        seq = _chain(mt, "float32")
        x, y = _data("float32")[0]
        seq._fit_step(mt.io.DataBatch([mt.nd.array(x)], [mt.nd.array(y)]))
    assert all(m._cached_step is None for m in seq._modules)


@pytest.mark.parametrize("case", ["names", "empty", "duplicate", "meta"])
def test_sequential_refusals_match_jax(case):
    errors = []
    for pkg in (mt, mx):
        with pkg.cpu():
            s1, s2 = _stages(pkg)
            seq = pkg.mod.SequentialModule()
            try:
                if case == "names":
                    errors.append((seq.data_names, seq.output_names))
                    seq.add(pkg.mod.Module(s1, label_names=()))
                    seq.add(pkg.mod.Module(s2), take_labels=True)
                    errors.append((seq.data_names, seq.output_names))
                    continue
                if case == "meta":
                    seq.add(pkg.mod.Module(s1), wiring=True)
                if case == "duplicate":
                    seq.add(pkg.mod.Module(s1, label_names=()),
                            auto_wiring=True)
                    seq.add(pkg.mod.Module(s1, label_names=()))
                seq.bind([("data", (BATCH, IN))])
                seq.init_params()
                errors.append(None)
            except ValueError as e:
                errors.append(type(e).__name__)
    assert errors[:len(errors) // 2] == errors[len(errors) // 2:]
    assert case == "names" or errors[0] == "ValueError"


# -- PythonModule --------------------------------------------------------------
def _doubler(pkg):
    class Doubler(pkg.mod.PythonModule):
        """Outputs twice its input; the input gradient twice the output
        gradient."""

        def _compute_output_shapes(self):
            return [(self._output_names[0], self._data_shapes[0][1])]

        def forward(self, data_batch, is_train=None):
            self._out = data_batch.data[0] * 2

        def get_outputs(self, merge_multi_context=True):
            return [self._out]

        def backward(self, out_grads=None):
            self._grad = out_grads[0] * 2

        def get_input_grads(self, merge_multi_context=True):
            return [self._grad]
    return Doubler(["data"], None, ["twice_output"])


def test_python_module_names_and_shapes_match_jax():
    got = []
    for pkg in (mt, mx):
        with pkg.cpu():
            m = _doubler(pkg)
            before = (m.data_names, m.output_names, m.binded,
                      m.get_params())
            m.bind([("data", (4, 3))], None, inputs_need_grad=True)
            m.init_params()
            m.init_optimizer()
            m.update()
            m.forward(pkg.io.DataBatch([pkg.nd.ones((4, 3))], None))
            m.backward([pkg.nd.ones((4, 3))])
            got.append((before, m.output_shapes, m.data_shapes,
                        m.label_shapes, m.binded, m.params_initialized,
                        m.optimizer_initialized, m.inputs_need_grad,
                        m.get_outputs()[0].asnumpy().tolist(),
                        m.get_input_grads()[0].asnumpy().tolist()))
    assert got[0] == got[1]


def test_python_loss_module_shapes_and_context():
    seen = {}

    def grad(scores, labels):
        seen.update(scores=scores.context, labels=labels.context)
        return np.ones(scores.shape)
    loss = mt.mod.PythonLossModule(grad_func=grad, context=mt.cpu())
    ref = mx.mod.PythonLossModule(grad_func=lambda s, l: np.ones(s.shape))
    for m, pkg in ((loss, mt), (ref, mx)):
        m.bind([pkg.io.DataDesc("data", (4, 2))],
               [pkg.io.DataDesc("softmax_label", (4,))])
    assert loss.output_names == ref.output_names == ["pyloss_output"]
    assert loss.output_shapes == ref.output_shapes == [("pyloss_output",
                                                        (4, 2))]
    assert loss.get_params() == ({}, {})
    with mt.cpu():
        loss.forward(mt.io.DataBatch([mt.nd.ones((4, 2))],
                                     [mt.nd.zeros((4,))]))
        loss.backward()
    g = loss.get_input_grads()[0]
    assert seen == {"scores": mt.cpu(), "labels": mt.cpu()}
    assert isinstance(g, mt.nd.NDArray) and g.context == mt.cpu()
    np.testing.assert_array_equal(g.asnumpy(), np.ones((4, 2)))
    with pytest.raises(TypeError):
        mt.mod.PythonLossModule(grad_func=3, context=mt.cpu())
    with pytest.raises(NotImplementedError):
        nograd = mt.mod.PythonLossModule(context=mt.cpu())
        nograd.bind([mt.io.DataDesc("data", (4, 2))], None)
        nograd.forward(mt.io.DataBatch([mt.nd.ones((4, 2), ctx=mt.cpu())],
                                       None))
        nograd.backward()


def test_python_module_takes_the_current_context(monkeypatch):
    """Like ``Module``, the default is the current context: the card,
    and with no card that raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError):
        mt.mod.PythonLossModule(grad_func=lambda s, l: s)
    with mt.cpu():
        assert mt.mod.PythonLossModule()._context == mt.cpu()
