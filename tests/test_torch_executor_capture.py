"""The Executor's programs (``mxnet_tpu_torch/executor.py``) against the
JAX package's jitted executor on the CPU.

The port's counterpart of each of ``tests/test_executor.py``'s 11 cases
and of ``tests/test_cached_step.py::test_fused_forward_backward_matches_
two_call``, each run eagerly and through the capture plumbing: under
``capture.stand_in`` with a graph class whose capture runs the stage once
and whose replay runs it again, the programs' warm-up, capture, buffer
and replay bookkeeping runs here as it does on the card (where CUDA
graphs replay).  Then the replays each entry point takes, captured
against eager bit for bit (one torch thread), and ``Module``'s
``forward``, ``backward`` and ``forward_backward`` through the programs.
"""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, capture, profiler

MODES = ["eager", "captured"]


class StandInGraph:
    """A test-only graph: ``capture`` runs the function once, ``replay``
    runs it again and copies its results into the captured outputs."""
    warmup_runs = 0

    def __init__(self, device, pool, generators):
        self.generators = generators

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


@pytest.fixture(autouse=True)
def _cpu_one_thread():
    """The port on the CPU, one torch thread (captured against eager is
    held bit for bit), counters from 0."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    profiler.reset_counters()
    with mt.cpu():
        yield
    torch.set_num_threads(prev)


def _mode(mode):
    return capture.stand_in(StandInGraph) if mode == "captured" \
        else contextlib.nullcontext()


def _steps():
    c = profiler.counters()
    return {k: c.get(k, 0) for k in ("graph_captures", "graph_replays",
                                     "program_calls")}


# -- tests/test_executor.py, case for case ------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_bind_forward_matches_numpy(mode):
    outs = {}
    for pkg in (mx, mt):
        a, b = pkg.sym.var("a"), pkg.sym.var("b")
        ex = (a + b * 2).bind(pkg.cpu(), {"a": pkg.nd.array([1., 2.]),
                                          "b": pkg.nd.array([3., 4.])})
        with _mode(mode if pkg is mt else "eager"):
            outs[pkg] = ex.forward()[0].asnumpy()
    np.testing.assert_allclose(outs[mt], [7., 10.])
    np.testing.assert_array_equal(outs[mt], outs[mx])


@pytest.mark.parametrize("mode", MODES)
def test_backward_grads(mode):
    got = {}
    for pkg in (mx, mt):
        x, y = pkg.sym.var("x"), pkg.sym.var("y")
        z = x * y + pkg.sym.square(x)
        xg, yg = pkg.nd.zeros((3,)), pkg.nd.zeros((3,))
        ex = z.bind(pkg.cpu(), {"x": pkg.nd.array([1., 2., 3.]),
                                "y": pkg.nd.array([4., 5., 6.])},
                    args_grad={"x": xg, "y": yg})
        with _mode(mode if pkg is mt else "eager"):
            ex.forward(is_train=True)
            ex.backward(pkg.nd.ones((3,)))
        got[pkg] = xg.asnumpy(), yg.asnumpy()
    np.testing.assert_allclose(got[mt][0], [4 + 2, 5 + 4, 6 + 6])
    np.testing.assert_allclose(got[mt][1], [1., 2., 3.])
    for a, b in zip(got[mt], got[mx]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_grad_req_add_and_null(mode):
    """``add`` accumulates over three steps (inside the program when
    captured); a ``null`` argument gets no gradient array."""
    got = {}
    for pkg in (mx, mt):
        x, w = pkg.sym.var("x"), pkg.sym.var("w")
        z = pkg.sym.sum(pkg.sym.square(x)) + pkg.sym.sum(w)
        xg = pkg.nd.zeros((2,))
        ex = z.bind(pkg.cpu(), {"x": pkg.nd.array([1., 2.]),
                                "w": pkg.nd.array([5., 6.])},
                    args_grad={"x": xg}, grad_req={"x": "add", "w": "null"})
        with _mode(mode if pkg is mt else "eager"):
            for _ in range(3):
                ex.forward(is_train=True)
                ex.backward()
        got[pkg] = xg.asnumpy()
        assert ex.grad_dict.get("w") is None
    np.testing.assert_allclose(got[mt], 3 * 2 * np.array([1., 2.]))
    np.testing.assert_array_equal(got[mt], got[mx])


@pytest.mark.parametrize("mode", MODES)
def test_simple_bind_infers_params(mode):
    for pkg in (mx, mt):
        net = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=5,
                                     name="fc")
        ex = net.simple_bind(pkg.cpu(), data=(7, 3))
        assert ex.arg_dict["fc_weight"].shape == (5, 3)
        assert ex.arg_dict["fc_bias"].shape == (5,)
        assert ex.grad_dict["fc_weight"].shape == (5, 3)
        with _mode(mode if pkg is mt else "eager"):
            assert ex.forward()[0].shape == (7, 5)


@pytest.mark.parametrize("mode", MODES)
def test_forward_kwargs_update_args(mode):
    """A batch fed as a keyword is copied into the bound array (the same
    tensor, so a captured program replays over it), and a second batch of
    that shape replays with no capture."""
    out = {}
    for pkg in (mx, mt):
        ex = pkg.sym.square(pkg.sym.var("data")).simple_bind(pkg.cpu(),
                                                             data=(2, 2))
        with _mode(mode if pkg is mt else "eager"):
            r1 = ex.forward(data=np.full((2, 2), 3.0, np.float32))
            if pkg is mt:
                bound = ex.arg_dict["data"]._data
                steps = _steps()
            r2 = ex.forward(data=np.full((2, 2), -2.0, np.float32))
        out[pkg] = r1[0].asnumpy(), r2[0].asnumpy()
    np.testing.assert_allclose(out[mt][0], 9 * np.ones((2, 2)))
    for a, b in zip(out[mt], out[mx]):
        np.testing.assert_array_equal(a, b)
    assert ex.arg_dict["data"]._data is bound
    want = dict(graph_captures=0, graph_replays=1, program_calls=1) \
        if mode == "captured" else dict(graph_captures=0, graph_replays=0,
                                        program_calls=0)
    assert {k: _steps()[k] - steps[k] for k in want} == want


@pytest.mark.parametrize("mode", MODES)
def test_aux_state_update_only_in_train(mode):
    x = np.random.RandomState(0).rand(16, 4).astype(np.float32) * 5
    got = {}
    for pkg in (mx, mt):
        bn = pkg.sym.BatchNorm(pkg.sym.var("d"), name="bn", momentum=0.0,
                               fix_gamma=True)
        ex = pkg.sym.sum(bn).simple_bind(pkg.cpu(), d=(16, 4))
        ex.aux_dict["bn_moving_var"][:] = 1.0
        before = ex.aux_dict["bn_moving_mean"].asnumpy().copy()
        with _mode(mode if pkg is mt else "eager"):
            ex.forward(is_train=False, d=x)
            eval_mean = ex.aux_dict["bn_moving_mean"].asnumpy().copy()
            ex.forward(is_train=True, d=x)
        got[pkg] = before, eval_mean, \
            ex.aux_dict["bn_moving_mean"].asnumpy()
    np.testing.assert_array_equal(got[mt][1], got[mt][0])
    # momentum 0: the moving mean is the batch mean
    np.testing.assert_allclose(got[mt][2], x.mean(axis=0), rtol=1e-5)
    np.testing.assert_allclose(got[mt][2], got[mx][2], rtol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_copy_params_from_and_outputs_dict(mode):
    for pkg in (mx, mt):
        net = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=2,
                                     name="fc")
        ex = net.simple_bind(pkg.cpu(), data=(1, 2))
        ex.copy_params_from({"fc_weight": pkg.nd.array([[1., 0.], [0., 1.]]),
                             "fc_bias": pkg.nd.array([1., 1.])})
        with _mode(mode if pkg is mt else "eager"):
            out = ex.forward(data=np.array([[2., 3.]], np.float32))
        np.testing.assert_allclose(out[0].asnumpy(), [[3., 4.]])
        assert "fc_output" in ex.output_dict


@pytest.mark.parametrize("mode", MODES)
def test_monitor_sees_intermediates(mode):
    """The monitor sees each op's output by the JAX package's names; an
    active monitor runs the graph eagerly, captured or not."""
    seen = {}
    for pkg in (mx, mt):
        net = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=2,
                                     name="fc")
        net = pkg.sym.Activation(net, act_type="relu", name="act")
        ex = net.simple_bind(pkg.cpu(), data=(1, 2))
        seen[pkg] = []
        ex.set_monitor_callback(lambda name, arr, s=seen[pkg]: s.append(
            (name, arr.asnumpy().copy())))
        with _mode(mode if pkg is mt else "eager"):
            ex.forward(is_train=False, data=np.ones((1, 2), np.float32))
    names = [n for n, _ in seen[mt]]
    assert any("fc_output" in s for s in names)
    assert any("act_output" in s for s in names)
    assert names == [n for n, _ in seen[mx]]
    assert _steps()["graph_replays"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_reshape(mode):
    got = {}
    for pkg in (mx, mt):
        net = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=4,
                                     name="fc")
        ex = net.simple_bind(pkg.cpu(), data=(2, 6))
        ex.arg_dict["fc_weight"][:] = 1.0
        ex2 = ex.reshape(data=(5, 6))
        assert ex2.arg_dict["data"].shape == (5, 6)
        np.testing.assert_allclose(ex2.arg_dict["fc_weight"].asnumpy(),
                                   np.ones((4, 6)))
        with _mode(mode if pkg is mt else "eager"):
            got[pkg] = ex2.forward(data=np.ones((5, 6), np.float32))[0] \
                .asnumpy()
    np.testing.assert_array_equal(got[mt], got[mx])


@pytest.mark.parametrize("mode", MODES)
def test_dropout_train_vs_eval_in_graph(mode):
    """Eval passes the input through; training drops about half, a new
    mask each call (the context's generator, registered with the
    program)."""
    ex = mt.sym.Dropout(mt.sym.var("d"), p=0.5).simple_bind(mt.cpu(),
                                                            d=(100, 100))
    x = np.ones((100, 100), np.float32)
    with _mode(mode):
        out_eval = ex.forward(is_train=False, d=x)[0].asnumpy()
        first = ex.forward(is_train=True, d=x)[0].asnumpy()
        second = ex.forward(is_train=True, d=x)[0].asnumpy()
    np.testing.assert_allclose(out_eval, x)
    for out in (first, second):
        assert 0.3 < (out == 0).mean() < 0.7
    assert not np.array_equal(first, second)
    ref = mx.sym.Dropout(mx.sym.var("d"), p=0.5).simple_bind(mx.cpu(),
                                                            d=(100, 100))
    np.testing.assert_array_equal(ref.forward(is_train=False, d=x)[0]
                                  .asnumpy(), out_eval)


@pytest.mark.parametrize("mode", MODES)
def test_group2ctx_places_nodes(mode):
    """Two groups of nodes on two contexts (here both the host): the same
    numbers as the ungrouped bind and as the JAX package, and a backward
    through the grouped path (which runs eagerly)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6).astype(np.float32)
    shapes = dict(zip(["g1fc_weight", "g1fc_bias", "g2fc_weight",
                       "g2fc_bias"], [(8, 6), (8,), (4, 8), (4,)]))
    params = {n: (rng.randn(*s) * 0.1).astype(np.float32)
              for n, s in shapes.items()}
    g2c = {"dev1": mt.cpu(0), "dev2": mt.cpu(1)}
    S = mt.sym
    h = S.FullyConnected(S.var("data"), num_hidden=8, name="g1fc",
                         attr={"ctx_group": "dev1"})
    h = S.Activation(h, act_type="tanh", attr={"ctx_group": "dev1"})
    out = S.FullyConnected(h, num_hidden=4, name="g2fc",
                           attr={"ctx_group": "dev2"})
    args = {"data": mt.nd.array(x)}
    args.update((n, mt.nd.array(v)) for n, v in params.items())
    with _mode(mode):
        y = out.bind(mt.cpu(0), args, group2ctx=g2c).forward()[0].asnumpy()
        y2 = out.bind(mt.cpu(0), args).forward()[0].asnumpy()
        grads = {n: mt.nd.zeros(s) for n, s in shapes.items()}
        ex3 = out.bind(mt.cpu(0), args, args_grad=grads, group2ctx=g2c)
        ex3.forward(is_train=True)
        ex3.backward(out_grads=mt.nd.ones((2, 4)))
    np.testing.assert_array_equal(y, y2)
    assert float(np.abs(grads["g1fc_weight"].asnumpy()).sum()) > 0
    ref_args = {"data": mx.nd.array(x)}
    ref_args.update((n, mx.nd.array(v)) for n, v in params.items())
    R = mx.sym
    with mx.AttrScope(ctx_group="dev1"):
        rh = R.FullyConnected(R.var("data"), num_hidden=8, name="g1fc")
        rh = R.Activation(rh, act_type="tanh")
    with mx.AttrScope(ctx_group="dev2"):
        rout = R.FullyConnected(rh, num_hidden=4, name="g2fc")
    ref = rout.bind(mx.cpu(0), ref_args,
                    group2ctx={"dev1": mx.cpu(0), "dev2": mx.cpu(1)})
    np.testing.assert_allclose(y, ref.forward()[0].asnumpy(), rtol=1e-5,
                               atol=1e-7)


# -- tests/test_cached_step.py ------------------------------------------------
def _mlp(pkg):
    S = pkg.sym
    h = S.relu(S.dot(S.Variable("data"), S.Variable("w1")))
    y = S.dot(h, S.Variable("w2"))
    return S.SoftmaxOutput(y, S.Variable("softmax_label"), name="softmax")


def _bind_mlp(pkg, bs=4, grad_req="write"):
    return _mlp(pkg).simple_bind(pkg.cpu(), grad_req=grad_req,
                                 data=(bs, 6), w1=(6, 8), w2=(8, 3),
                                 softmax_label=(bs,))


def _mlp_feed(seed, bs=4):
    rng = np.random.RandomState(seed)
    return dict(data=rng.randn(bs, 6).astype(np.float32),
                softmax_label=rng.randint(0, 3, (bs,)).astype(np.float32))


@pytest.mark.parametrize("mode", MODES)
def test_fused_forward_backward_matches_two_call(mode):
    """``forward_backward`` (one program) against ``forward`` then
    ``backward`` (two stages of another), and both against the JAX
    package's two programs."""
    rng = np.random.RandomState(1)
    w = dict(w1=rng.randn(6, 8) * 0.1, w2=rng.randn(8, 3) * 0.1)
    feed = _mlp_feed(1)
    got = {}
    for pkg in (mx, mt):
        ex_a, ex_b = _bind_mlp(pkg), _bind_mlp(pkg)
        for ex in (ex_a, ex_b):
            for n, v in w.items():
                ex.arg_dict[n][:] = v.astype(np.float32)
        with _mode(mode if pkg is mt else "eager"):
            ex_a.forward(is_train=True, **feed)
            ex_a.backward()
            ex_b.forward_backward(**feed)
        got[pkg] = [ex.outputs[0].asnumpy() for ex in (ex_a, ex_b)] + [
            ex.grad_dict[n].asnumpy() for ex in (ex_a, ex_b)
            for n in ("w1", "w2")]
    a, b = got[mt][:2], got[mt][2:]
    np.testing.assert_allclose(a[0], a[1], rtol=1e-6)
    for u, v in zip(b[:2], b[2:]):
        np.testing.assert_allclose(u, v, rtol=1e-5, atol=1e-6)
    for u, v in zip(got[mt], got[mx]):
        np.testing.assert_allclose(u, v, rtol=1e-5, atol=1e-6)
    if mode == "captured":
        assert len(ex_b._caches[False]) == 1   # one program, its key


# -- the port's own: replays, captured against eager --------------------------
def test_one_replay_per_forward_and_per_backward():
    """Captured: the first training forward captures its program (two
    stages), then each ``forward`` and each ``backward`` is one replay; a
    new batch of the same shape replays with no capture;
    ``forward_backward`` is one program, one replay a call; an eval
    forward one more program."""
    ex = _bind_mlp(mt)
    with _mode("captured"):
        ex.forward(is_train=True, **_mlp_feed(0))
        assert _steps() == dict(graph_captures=2, graph_replays=1,
                                program_calls=1)
        ex.backward()
        assert _steps() == dict(graph_captures=2, graph_replays=2,
                                program_calls=2)
        for seed in (1, 2):
            ex.forward(is_train=True, **_mlp_feed(seed))
            ex.backward()
        assert _steps() == dict(graph_captures=2, graph_replays=6,
                                program_calls=6)
        for seed in (3, 4, 5):
            ex.forward_backward(**_mlp_feed(seed))
        assert _steps() == dict(graph_captures=3, graph_replays=9,
                                program_calls=9)
        ex.forward(is_train=False, **_mlp_feed(6))
        ex.forward(is_train=False, **_mlp_feed(7))
        assert _steps() == dict(graph_captures=4, graph_replays=11,
                                program_calls=11)
        with pytest.raises(MXNetError, match="before forward"):
            ex.backward()


def _mlp_run(mode, grad_req, calls):
    ex = _bind_mlp(mt, grad_req=grad_req)
    rng = np.random.RandomState(3)
    for n, s in (("w1", (6, 8)), ("w2", (8, 3))):
        ex.arg_dict[n][:] = (rng.randn(*s) * 0.3).astype(np.float32)
    og = mt.nd.array(rng.randn(4, 3).astype(np.float32))
    outs = []
    with _mode(mode):
        for i, call in enumerate(calls):
            feed = _mlp_feed(10 + i)
            if call == "two":
                ex.forward(is_train=True, **feed)
                ex.backward()
            elif call == "fb":
                ex.forward_backward(**feed)
            elif call == "fb_og":
                ex.forward_backward(out_grads=og, **feed)
            else:
                ex.forward(is_train=False, **feed)
            outs.append(ex.outputs[0].asnumpy().copy())
            outs += [ex.grad_dict[n].asnumpy().copy() for n in ("w1", "w2")]
    return outs


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_captured_equals_eager_bit_for_bit(grad_req):
    """Every entry point, in turns, captured against eager: outputs and
    gradients equal bit for bit (``add`` accumulating in the programs)."""
    calls = ["two", "fb", "eval", "fb_og", "two", "fb", "fb_og", "eval"]
    eager = _mlp_run("eager", grad_req, calls)
    captured = _mlp_run("captured", grad_req, calls)
    for a, b in zip(eager, captured):
        np.testing.assert_array_equal(a, b)


def test_backward_out_grads_captured_matches_jax():
    """``backward(out_grads)`` through the program's second stage against
    the JAX package's ``_bwd_jit``."""
    rng = np.random.RandomState(2)
    wv, og = rng.randn(5, 2), rng.randn(3, 2)
    data = rng.randn(3, 5)
    got = {}
    for pkg in (mx, mt):
        y = pkg.sym.dot(pkg.sym.Variable("data"), pkg.sym.Variable("w"))
        ex = y.simple_bind(pkg.cpu(), grad_req="write", data=(3, 5),
                           w=(5, 2))
        ex.arg_dict["w"][:] = wv.astype(np.float32)
        with _mode("captured" if pkg is mt else "eager"):
            ex.forward(is_train=True, data=pkg.nd.array(data))
            ex.backward(pkg.nd.array(og))
        got[pkg] = ex.grad_dict["w"].asnumpy()
    np.testing.assert_allclose(got[mt], got[mx], rtol=1e-5, atol=1e-6)


def test_module_entry_points_replay_the_programs():
    """``Module.forward``/``backward``/``forward_backward`` and a step with
    a store (the two-call path) replay the executor's programs, which
    capture into the module's pool."""
    S = mt.sym
    net = S.SoftmaxOutput(S.FullyConnected(S.var("data"), num_hidden=3,
                                           name="fc"), name="softmax")
    rng = np.random.RandomState(4)
    batches = [mt.io.DataBatch(
        [mt.nd.array(rng.randn(8, 5).astype(np.float32))],
        [mt.nd.array(rng.randint(0, 3, 8).astype(np.float32))])
        for _ in range(3)]
    runs = {}
    for mode in MODES:
        mt.random.seed(0)
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.bind(data_shapes=[("data", (8, 5))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params()
        mod.init_optimizer(kvstore=mt.kv.create("local"),
                           optimizer_params=(("learning_rate", 0.1),))
        ex = mod._exec_group.execs[0]
        assert ex.graph_pool is mod._graph_pool
        profiler.reset_counters()
        outs = []
        with _mode(mode):
            for b in batches:
                mod._fit_step(b)      # a store: forward_backward, update
                outs.append(mod.get_outputs()[0].asnumpy())
            fit_steps = _steps()
            mod.forward(batches[0], is_train=True)
            mod.backward()
            mod.forward(batches[1], is_train=False)
            outs.append(mod.get_outputs()[0].asnumpy())
        runs[mode] = outs, {k: v.asnumpy() for k, v in
                            mod.get_params()[0].items()}
        if mode == "captured":
            # (the store's update is no program of the executor's)
            replays = {k: v for k, v in _steps().items()
                       if k != "program_calls"}
            assert fit_steps["graph_captures"] == 1
            assert fit_steps["graph_replays"] == 3
            assert replays == dict(graph_captures=4, graph_replays=6)
    for a, b in zip(runs["eager"][0], runs["captured"][0]):
        np.testing.assert_array_equal(a, b)
    for k in runs["eager"][1]:
        np.testing.assert_array_equal(runs["eager"][1][k],
                                      runs["captured"][1][k])


def test_custom_op_graph_stays_eager():
    """A graph holding a ``Custom`` op runs eagerly where it would be
    captured, one ``host_op_programs`` an entry point."""
    class Twice(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 2)

    @mt.operator.register("exec_capture_twice")
    class TwiceProp(mt.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Twice()

    y = mt.sym.sum(mt.sym.Custom(mt.sym.var("x"),
                                 op_type="exec_capture_twice"))
    ex = y.simple_bind(mt.cpu(), x=(3,))
    ex.arg_dict["x"][:] = 1.0
    with _mode("captured"):
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        ex.forward_backward()
    assert float(out) == 6.0
    np.testing.assert_array_equal(ex.grad_dict["x"].asnumpy(), [2., 2., 2.])
    assert profiler.counter("host_op_programs") == 2
    assert _steps()["graph_captures"] == 0
