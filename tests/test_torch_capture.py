"""Captured steps (``mxnet_tpu_torch.capture``) on the CPU, against the JAX
package's one-program-per-step contracts.

On the CPU every entry point runs eagerly; these tests drive the capture
plumbing through a stand-in graph (:class:`StandInGraph`, handed to
``capture.stand_in``): its ``capture`` runs the step once and its
``replay`` runs it again on the same static buffers, so the keys, the
static inputs and outputs, the buffer checks, the traced
hyper-parameters, the snapshot around a capture and the counters are the
ones the card's CUDA graphs get.  The cases mirror
``tests/test_cached_step.py`` and ``tests/test_fused_trainer.py`` one for
one, each run in both packages where the reference has it, and add the
port's own.  Tolerances: the captured Module step against the JAX
package's ``CachedTrainStep``, rtol 2e-5 and atol 1e-6, the reference's
own limits for its fused step against its slow path; the captured
Trainer against the JAX package's, 1e-6 relative in fp32 (the limit of
``tests/test_torch_gluon_train.py``); a captured step against the same
step run eagerly in this package, bit for bit (the same operations in
the same order).
"""
import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx
from mxnet_tpu import profiler as jax_profiler
from mxnet_tpu.gluon import fused_trainer as jax_fused

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, capture, profiler
from mxnet_tpu_torch.gluon import fused_trainer as port_fused
from mxnet_tpu_torch.models import transformer as tr
from mxnet_tpu_torch.optimizer import TracedHyper, _state_raw

FP32_REL = 1e-6


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


class WarmingGraph(StandInGraph):
    """The stand-in with two warm-up runs, on no stream of its own."""
    warmup_runs = 2

    @staticmethod
    def side_stream(device):
        return contextlib.nullcontext()


@pytest.fixture(autouse=True)
def counters_and_threads():
    """One torch thread: the CPU's multi-threaded reductions are not bit
    reproducible from run to run, and captured steps are held against
    eager ones bit for bit."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    profiler.reset_counters()
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def fused_env():
    """Set ``MXNET_FUSED_TRAINER`` for both packages; restored after."""
    prev = os.environ.get("MXNET_FUSED_TRAINER")

    def set_(value):
        os.environ["MXNET_FUSED_TRAINER"] = value
        jax_fused.refresh_from_env()
        port_fused.refresh_from_env()
    yield set_
    if prev is None:
        os.environ.pop("MXNET_FUSED_TRAINER", None)
    else:
        os.environ["MXNET_FUSED_TRAINER"] = prev
    jax_fused.refresh_from_env()
    port_fused.refresh_from_env()


def _counts():
    return (profiler.counter("graph_captures"),
            profiler.counter("graph_replays"),
            profiler.counter("program_calls"))


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)
                        / np.maximum(1.0, np.abs(b))))


# -- tests/test_cached_step.py ------------------------------------------------
def _mlp(pkg):
    """The reference's ``relu(data . w1) . w2`` into a softmax; the port
    (which has no ``dot`` yet) takes the products as bias-free
    ``FullyConnected`` layers, its weights transposed."""
    s = pkg.sym
    if pkg is mx:
        h = s.relu(s.dot(s.Variable("data"), s.Variable("w1")))
        y = s.dot(h, s.Variable("w2"))
    else:
        h = s.relu(s.FullyConnected(s.Variable("data"), s.Variable("w1"),
                                    num_hidden=8, no_bias=True))
        y = s.FullyConnected(h, s.Variable("w2"), num_hidden=3,
                             no_bias=True)
    return s.SoftmaxOutput(y, s.Variable("softmax_label"), name="softmax")


def _small_net(pkg):
    s = pkg.sym
    with pkg.name.NameManager():
        net = s.FullyConnected(s.Variable("data"), num_hidden=8, name="fc1")
        net = s.Activation(net, act_type="relu", name="relu1")
        net = s.FullyConnected(net, num_hidden=3, name="fc2")
        return s.SoftmaxOutput(net, s.Variable("softmax_label"),
                               name="softmax")


def _data_iter(pkg, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(32, 6).astype(np.float32)
    Y = rng.randint(0, 3, (32,)).astype(np.float32)
    return pkg.io.NDArrayIter(X, Y, batch_size=8,
                              label_name="softmax_label")


def _fit_module(pkg, optimizer="sgd",
                opt_params=(("learning_rate", 0.1), ("momentum", 0.9)),
                num_epoch=2, init=None):
    """``tests/test_cached_step.py::_fit_module``, from ``init`` (numpy
    arg and aux dicts) where given."""
    it = _data_iter(pkg)
    mod = pkg.mod.Module(_small_net(pkg), context=pkg.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    if init is None:
        mod.init_params(initializer=pkg.initializer.Xavier(
            rnd_type="uniform", magnitude=2.0))
    elif pkg is mt:
        mod.set_params(*mt.mod.params_from_jax(
            *init, mod.symbol, ctx=mt.cpu(), data_shapes=it.provide_data))
    else:
        mod.set_params(*[{k: mx.nd.array(v) for k, v in d.items()}
                         for d in init])
    mod.init_optimizer(optimizer=optimizer, optimizer_params=opt_params)
    if num_epoch:
        mod.fit(it, num_epoch=num_epoch)
    return mod


def _host_params(mod):
    return [{k: v.asnumpy() for k, v in d.items()} for d in mod.get_params()]


def test_no_retrace_across_steps():
    """4 steps: one program, captured once, replayed 4 times."""
    ex = _mlp(mx).simple_bind(mx.cpu(), grad_req="write", data=(4, 6),
                              w1=(6, 8), w2=(8, 3), softmax_label=(4,))
    rng = np.random.RandomState(0)
    batches = [(rng.randn(4, 6), rng.randint(0, 3, (4,))) for _ in range(4)]
    for x, y in batches:
        ex.forward(is_train=True, data=mx.nd.array(x),
                   softmax_label=mx.nd.array(y))
        ex.backward()
    assert ex._fwd_train_jit._cache_size() == 1
    assert ex._bwd_jit._cache_size() == 1

    pex = _mlp(mt).simple_bind(mt.cpu(), grad_req={"w1": "write",
                                                   "w2": "write"},
                               data=(4, 6), w1=(8, 6), w2=(3, 8),
                               softmax_label=(4,))
    opt = mt.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    step = mt.module.cached_step.CachedTrainStep(
        pex, mt.optimizer.get_updater(opt), ["w1", "w2"])
    with capture.stand_in(StandInGraph):
        for x, y in batches:
            step.run({"data": mt.nd.array(x, ctx=mt.cpu()),
                      "softmax_label": mt.nd.array(y, ctx=mt.cpu())})
    assert _counts() == (1, 4, 4)
    assert len(step._programs) == 1


def test_module_fit_uses_one_donated_program():
    """``Module.fit``: 2 epochs of 4 batches through the cached step, one
    program captured once and replayed once a step."""
    mod = _fit_module(mx)
    assert mod._cached_step is not None
    assert mod._cached_step._step_jit._cache_size() == 1

    with capture.stand_in(StandInGraph):
        pmod = _fit_module(mt)
    assert pmod._cached_step is not None
    assert _counts() == (1, 8, 8)
    assert len(pmod._cached_step._programs) == 1


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", (("learning_rate", 0.1), ("momentum", 0.9))),
    ("adam", (("learning_rate", 0.01),))])
def test_module_fused_step_matches_slow_path(monkeypatch, optimizer, params):
    """From one numpy init: the JAX package's fused step against its slow
    path (the reference case); the captured port step against the JAX
    package's ``CachedTrainStep`` and against this package's two-call
    path, at the reference's limits; and bit for bit against this
    package's eager fused step."""
    init = _host_params(_fit_module(mx, optimizer, params, num_epoch=0))
    ref = _fit_module(mx, optimizer, params, init=init)
    assert ref._cached_step is not None
    with capture.stand_in(StandInGraph):
        got = _fit_module(mt, optimizer, params, init=init)
    assert _counts()[:2] == (1, 8)
    eager = _fit_module(mt, optimizer, params, init=init)
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "0")
    slow = _fit_module(mx, optimizer, params, init=init)
    port_slow = _fit_module(mt, optimizer, params, init=init)
    assert not slow._cached_step and port_slow._cached_step is None
    ra, ga, ea = (_host_params(m)[0] for m in (ref, got, eager))
    sa, pa = _host_params(slow)[0], _host_params(port_slow)[0]
    for name in ra:
        for a, b in ((ra, sa), (ga, ra), (ga, pa)):
            np.testing.assert_allclose(
                a[name], b[name], rtol=2e-5, atol=1e-6,
                err_msg="%s/%s diverged" % (optimizer, name))
        np.testing.assert_array_equal(ga[name], ea[name], err_msg=name)


def _reshape_module(pkg):
    mod = pkg.mod.Module(_small_net(pkg), context=pkg.cpu())
    mod.bind(data_shapes=[pkg.io.DataDesc("data", (8, 6))],
             label_shapes=[pkg.io.DataDesc("softmax_label", (8,))])
    mod.init_params(initializer=pkg.initializer.Xavier())
    return mod


def test_reshape_alternation_reuses_groups_and_programs():
    """Alternating batch shapes reuse each shape's executor group and its
    captured program."""
    for pkg in (mx, mt):
        rng = np.random.RandomState(7)
        mod = _reshape_module(pkg)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.1),))
        groups, steps = set(), set()
        with capture.stand_in(StandInGraph):
            for _ in range(3):
                for bs in (8, 5):
                    mod._fit_step(pkg.io.DataBatch(
                        [pkg.nd.array(rng.randn(bs, 6), ctx=pkg.cpu())],
                        [pkg.nd.array(rng.randint(0, 3, (bs,)),
                                      ctx=pkg.cpu())]))
                    groups.add(id(mod._exec_group))
                    assert mod._cached_step is not None
                    steps.add(id(mod._cached_step))
        assert len(groups) == 2 and len(steps) == 2
        if pkg is mx:
            assert mod._cached_step._step_jit._cache_size() == 1
        else:
            assert len(mod._cached_step._programs) == 1
            assert _counts()[:2] == (2, 6)


def test_reshape_cache_bounded(monkeypatch):
    monkeypatch.setenv("MXNET_MODULE_RESHAPE_CACHE", "3")
    for pkg in (mx, mt):
        mod = _reshape_module(pkg)
        for bs in (7, 6, 5, 4, 3, 2):
            mod.reshape([pkg.io.DataDesc("data", (bs, 6))],
                        [pkg.io.DataDesc("softmax_label", (bs,))])
        assert len(mod._reshape_cache) <= 3
    # and a step's programs: at most MAX_PROGRAMS, the oldest dropped
    cache = capture.StepCache("bounded")
    w = torch.zeros(3)
    with capture.stand_in(StandInGraph):
        for n in range(capture.MAX_PROGRAMS + 3):
            x = torch.ones(n + 1)
            cache.program("k", StandInGraph, w.device,
                          lambda: [lambda x: [x * 2]], [x], [w])
    assert len(cache) == capture.MAX_PROGRAMS


# -- tests/test_fused_trainer.py ----------------------------------------------
def _dense_net(pkg, n_layers=3, width=8):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        for _ in range(n_layers - 1):
            net.add(pkg.gluon.nn.Dense(width, activation="relu"))
        net.add(pkg.gluon.nn.Dense(3))
    return net


def _train(pkg, optimizer, opt_params, steps=5, lr_schedule=None,
           hybridize=False, seed=0, batch_size=16):
    """``tests/test_fused_trainer.py::_train``'s regression net: Xavier
    from ``seed``, ``steps`` Trainer steps on L2Loss.  Returns (weights by
    slot, the Trainer)."""
    with pkg.cpu():
        np.random.seed(seed)
        pkg.random.seed(seed)
        rng = np.random.RandomState(seed + 1)
        with pkg.name.NameManager():
            net = _dense_net(pkg)
        net.initialize(init=pkg.initializer.Xavier())
        net(pkg.nd.array(np.zeros((1, 6), np.float32)))
        if hybridize:
            net.hybridize()
        trainer = pkg.gluon.Trainer(net.collect_params(), optimizer,
                                    dict(opt_params))
        loss_fn = pkg.gluon.loss.L2Loss()
        X = rng.randn(steps, batch_size, 6).astype(np.float32)
        Y = rng.randn(steps, batch_size, 3).astype(np.float32)
        for step in range(steps):
            if lr_schedule is not None:
                trainer.set_learning_rate(lr_schedule(step))
            with pkg.autograd.record():
                loss = loss_fn(net(pkg.nd.array(X[step])),
                               pkg.nd.array(Y[step]))
            loss.backward()
            trainer.step(batch_size)
        weights = {i: p.data().asnumpy()
                   for i, p in enumerate(net.collect_params().values())}
        return weights, trainer


def test_no_retrace_across_lr_schedule(fused_env):
    """Adam under a halving lr schedule, 5 steps: the update captured once
    (lr, wd and t traced); the weights are the JAX run's."""
    fused_env("1")
    ref, jtrainer = _train(mx, "adam", (("learning_rate", 0.01),),
                           lr_schedule=lambda s: 0.01 * 0.5 ** s)
    assert jtrainer._fused_step_jit._cache_size() == 1
    with capture.stand_in(StandInGraph):
        got, trainer = _train(mt, "adam", (("learning_rate", 0.01),),
                              lr_schedule=lambda s: 0.01 * 0.5 ** s)
    assert _counts()[:2] == (1, 5)
    assert len(trainer._programs) == 1
    assert max(_rel(got[k], ref[k]) for k in ref) <= FP32_REL


def _one_step_calls(pkg, counter):
    with pkg.cpu():
        np.random.seed(0)
        net = _dense_net(pkg, n_layers=12)
        net.initialize(init=pkg.initializer.Xavier())
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1, "momentum": 0.9})
        loss_fn = pkg.gluon.loss.L2Loss()
        x = pkg.nd.array(np.random.randn(8, 6).astype(np.float32))
        y = pkg.nd.array(np.random.randn(8, 3).astype(np.float32))
        calls = []
        for _ in range(2):
            with pkg.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            before = counter()
            trainer.step(8)
            calls.append(counter() - before)
        return len(net.collect_params()), calls


@pytest.mark.parametrize("captured", [False, True])
def test_fused_program_call_count(fused_env, captured):
    """24 parameters: at most 4 program calls a step (one, here)."""
    fused_env("1")
    n, calls = _one_step_calls(
        mx, lambda: jax_profiler.counter("xla_program_calls"))
    assert n >= 20 and calls[-1] <= 4
    with capture.stand_in(StandInGraph) if captured \
            else contextlib.nullcontext():
        n, calls = _one_step_calls(
            mt, lambda: profiler.counter("program_calls"))
    assert n >= 20 and calls == [1, 1]
    assert profiler.counter("graph_replays") == (2 if captured else 0)


def test_loop_program_call_count_is_per_slot(fused_env):
    fused_env("0")
    n, calls = _one_step_calls(
        mx, lambda: jax_profiler.counter("xla_program_calls"))
    assert calls[-1] >= n
    n, calls = _one_step_calls(mt, lambda: profiler.counter("program_calls"))
    assert calls == [n, n]


# -- the port's own -----------------------------------------------------------
def test_set_states_after_capture_recaptures():
    """``Updater.set_states`` rebinds the momenta: the next step
    recaptures, and the run matches the eager one."""
    init = _host_params(_fit_module(mx, num_epoch=0))

    def run(captured):
        with capture.stand_in(StandInGraph) if captured \
                else contextlib.nullcontext():
            mod = _fit_module(mt, num_epoch=1, init=init)
            before = profiler.counter("graph_captures")
            mod._updater.set_states(mod._updater.get_states())
            mod.fit(_data_iter(mt), num_epoch=1)
            recaptured = profiler.counter("graph_captures") - before
        return _host_params(mod)[0], recaptured
    got, recaptured = run(True)
    want, _ = run(False)
    assert recaptured == 1
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_outputs_outlive_the_next_step():
    """An output of step k keeps its value after step k+1, in Module, a
    hybridized block and the LM step."""
    rng = np.random.RandomState(3)
    with capture.stand_in(StandInGraph), mt.cpu():
        mod = _reshape_module(mt)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.5),))
        outs = []
        for _ in range(2):
            mod._fit_step(mt.io.DataBatch(
                [mt.nd.array(rng.randn(8, 6))],
                [mt.nd.array(rng.randint(0, 3, (8,)))]))
            outs.append(mod.get_outputs()[0])
            if len(outs) == 1:
                first = outs[0].asnumpy().copy()
        np.testing.assert_array_equal(outs[0].asnumpy(), first)
        assert not np.array_equal(outs[1].asnumpy(), first)

        net = _dense_net(mt)
        net.initialize(init=mt.initializer.Xavier())
        net.hybridize()
        y1 = net(mt.nd.array(rng.randn(4, 6)))
        keep = y1.asnumpy().copy()
        net(mt.nd.array(rng.randn(4, 6)))
        np.testing.assert_array_equal(y1.asnumpy(), keep)

        cfg = tr.TransformerLMConfig(vocab=32, d_model=16, n_heads=2,
                                     d_ff=32, n_layers=1, max_len=16)
        params = tr.init_transformer_params(
            torch.Generator().manual_seed(0), cfg, device="cpu")
        tok = torch.randint(0, 32, (2, 9), generator=torch.Generator()
                            .manual_seed(1))
        step = tr.make_train_step(cfg, lr=0.5, device="cpu")
        _, loss1 = step(params, tok[:, :-1], tok[:, 1:])
        l1 = loss1.item()
        _, loss2 = step(params, tok[:, :-1], tok[:, 1:])
        assert loss1.item() == l1 and loss2.item() != l1


def test_replays_add_the_captured_launch_deltas():
    """A stage that launches (here: bumps) twice counts twice a replay;
    warm-ups count as the launches they are; the capture itself counts
    nothing."""
    w = torch.zeros(4)

    def stage(x):
        profiler.bump("test_launches", 2)
        with torch.no_grad():
            w.add_(x)
        return [w * 1.0]
    for graph_class, warm in ((StandInGraph, 0), (WarmingGraph, 2)):
        profiler.reset_counters()
        w.zero_()
        with capture.stand_in(graph_class):
            prog = capture.Program("test", graph_class, w.device, [stage],
                                   [torch.ones(4)], [w])
            assert profiler.counter("test_launches") == 2 * warm
            assert torch.equal(w, torch.zeros(4))  # warm-ups and capture undone
            for k in range(3):
                out = prog.replay(0, [torch.ones(4)])
                assert torch.equal(out[0], torch.full((4,), k + 1.0))
        assert profiler.counter("test_launches") == 2 * (warm + 3)
        assert _counts() == (1, 3, 3)


# the other rules' options, as ``tests/test_torch_optimizer.py`` sets them
RULE_KW = {"rmsprop": dict(centered=True)}


def _fused_case(name, dtype, mp=False, momentum=0.9, **kw):
    """Weights, grads and states of a few slots for ``name``."""
    gen = torch.Generator().manual_seed(5)
    shapes = [(7,), (3, 4), (5,)]
    ws = [torch.randn(s, generator=gen).to(dtype) for s in shapes]
    gs = [torch.randn(s, generator=gen).to(dtype) for s in shapes]
    kw.update(RULE_KW.get(name, {}))
    if momentum is not None and name != "sgd":
        kw["momentum"] = momentum
    opt = mt.optimizer.create(name, learning_rate=0.1, wd=1e-3,
                              rescale_grad=0.5, clip_gradient=0.3,
                              multi_precision=mp, momentum=momentum, **kw) \
        if name == "sgd" else mt.optimizer.create(
            name, learning_rate=0.01, wd=1e-3, rescale_grad=0.5, **kw)
    nds = [mt.nd.NDArray(w, mt.cpu()) for w in ws]
    states = [opt.create_state(i, w) for i, w in enumerate(nds)]
    return opt, ws, gs, states


@pytest.mark.parametrize("name,dtype,mp,momentum", [
    ("sgd", torch.float32, False, 0.0), ("sgd", torch.float32, False, 0.9),
    ("sgd", torch.float64, False, 0.0), ("sgd", torch.float64, False, 0.9),
    ("sgd", torch.float16, True, 0.9), ("sgd", torch.float16, True, 0.0),
    ("adam", torch.float32, False, None),
    ("adam", torch.float64, False, None)] + [
        (name, dtype, False, momentum)
        for name, momentum in (("nag", 0.9), ("sgld", None), ("dcasgd", 0.9),
                               ("adagrad", None), ("rmsprop", None),
                               ("adadelta", None), ("ftrl", None),
                               ("adamax", None), ("nadam", None),
                               ("signum", 0.9), ("signum", 0.0))
        for dtype in (torch.float32, torch.float64)])
def test_traced_fused_update_is_bitwise(name, dtype, mp, momentum):
    """``fused_update`` with traced hyper-parameters (``TracedHyper``, its
    values in a tensor) against the float form and against the
    per-parameter loop, 3 steps with a changing lr, bit for bit, for
    every rule with a fused form; lr_mult differs between slots, so the
    slots fall in two groups.  (bf16 slots are held on the card,
    ``chip_smoke.py``: on the CPU a multi-tensor op rounds a float scalar
    to the slot's 16-bit type before it multiplies, so not even the float
    form is the loop there.)"""
    results = []
    for form in ("float", "traced", "loop"):
        mt.random.seed(0)  # SGLD's noise
        opt, ws, gs, states = _fused_case(name, dtype, mp, momentum)
        opt.set_lr_mult({0: 2.0})
        for t in range(3):
            opt.lr = 0.1 * 0.5 ** t if name == "sgd" else 0.01 * 0.5 ** t
            if form == "loop":
                for i, (w, g) in enumerate(zip(ws, gs)):
                    wn, gn = mt.nd.NDArray(w, mt.cpu()), \
                        mt.nd.NDArray(g, mt.cpu())
                    opt.update(i, wn, gn, states[i])
                    ws[i] = wn._data
                continue
            raw = [_state_raw(s) for s in states]
            for i in range(len(ws)):
                opt._update_count(i)
            lrs = [opt._get_lr(i) for i in range(len(ws))]
            wds = [opt._get_wd(i) for i in range(len(ws))]
            counts = [opt._index_update_count[i] for i in range(len(ws))]
            if form == "float":
                opt.fused_update(ws, gs, raw, lrs, wds, counts)
            else:
                hyper = TracedHyper(opt, lrs, wds, counts)
                assert hyper.key[0] == "traced"
                opt.fused_update(ws, gs, raw, **hyper.unpack(
                    hyper.values.clone()))
        flat = list(ws)
        for s in states:
            raw = _state_raw(s)
            flat += [x for x in (raw if isinstance(raw, tuple) else (raw,))
                     if x is not None]
        results.append(flat)
    for other in results[1:]:
        assert len(other) == len(results[0])
        for a, b in zip(results[0], other):
            assert torch.equal(a, b)


class _HostRule(mt.optimizer.Optimizer):
    """A rule of a user's own: a fused update on host floats, with no
    ``step_scalars``."""

    def update_step(self, w, g, state, hyper):
        return w - hyper["lr"] * hyper["t"] * g, None

    @torch.no_grad()
    def fused_update(self, weights, grads, states, lrs, wds, counts,
                     traced=None):
        torch._foreach_sub_(weights, torch._foreach_mul(
            grads, [lr * t for lr, t in zip(lrs, counts)]))


def test_host_float_rules_key_on_their_floats(fused_env):
    """A rule without a traced form keys its capture on the floats it
    freezes, the counts too, and one program of its family replaces the
    last; the port's rules key on neither lr nor t."""
    w = [torch.zeros(3)]
    user = _HostRule(learning_rate=0.01)
    a = TracedHyper(user, [0.01], [0.0], [1])
    assert a.key != TracedHyper(user, [0.01], [0.0], [2]).key
    assert a.key != TracedHyper(user, [0.02], [0.0], [1]).key
    assert a.family == TracedHyper(user, [0.02], [0.0], [2]).family
    for name in ("rmsprop", "nadam", "adamax", "adam", "sgld", "ftrl"):
        opt = mt.optimizer.create(name, learning_rate=0.01)
        b = TracedHyper(opt, [0.01], [0.0], [1])
        assert b.family is None
        assert b.key == TracedHyper(opt, [0.02], [0.0], [7]).key, name
    sgd = mt.optimizer.create("sgd", momentum=0.9)
    key = TracedHyper(sgd, [0.01], [0.0], [1]).key
    sgd.momentum = 0.5
    assert TracedHyper(sgd, [0.01], [0.0], [1]).key != key
    # a Trainer step of the user's rule: one program at a time
    fused_env("1")
    with capture.stand_in(StandInGraph), mt.cpu():
        p = mt.gluon.Parameter("w", shape=(3,))
        p.initialize(mt.init.One(), ctx=mt.cpu())
        trainer = mt.gluon.Trainer([p], user)
        for step in range(3):
            p.grad()._data.fill_(1.0)
            p._fresh_grad = True
            trainer.step(1)
            assert len(trainer._programs) == 1
    assert _counts()[:2] == (3, 3)
    want = 1.0 - 0.01 * (1 + 2 + 3)
    assert torch.allclose(p.data()._data, torch.full((3,), want))


def _gluon_steps(steps=3, optimizer="sgd"):
    with mt.cpu():
        mt.random.seed(0)
        rng = np.random.RandomState(1)
        with mt.name.NameManager():
            net = _dense_net(mt)
        net.initialize(init=mt.initializer.Xavier())
        net.hybridize()
        trainer = mt.gluon.Trainer(net.collect_params(), optimizer,
                                   {"learning_rate": 0.1, "wd": 1e-3})
        loss_fn = mt.gluon.loss.L2Loss()
        per_step = []
        for _ in range(steps):
            x = mt.nd.array(rng.randn(16, 6).astype(np.float32))
            y = mt.nd.array(rng.randn(16, 3).astype(np.float32))
            before = _counts()
            with mt.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(16)
            per_step.append(tuple(b - a for a, b in zip(before, _counts())))
        return ([p.data().asnumpy() for p in net.collect_params().values()],
                [p.grad().asnumpy() for p in net.collect_params().values()],
                per_step)


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "rmsprop"])
def test_gluon_step_is_three_replays(optimizer):
    """A hybridized Gluon step: forward, backward and update, one replay
    each after the first step's three captures; weights and gradients
    bit for bit with the eager run."""
    with capture.stand_in(StandInGraph):
        got = _gluon_steps(optimizer=optimizer)
    want = _gluon_steps(optimizer=optimizer)
    assert got[2] == [(3, 3, 3), (0, 3, 3), (0, 3, 3)]
    assert want[2] == [(0, 0, 1)] * 3
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(a, b)


def test_gluon_stale_grad_rule_holds_when_captured(fused_env):
    """A Parameter the captured forward does not reach keeps a stale
    gradient: ``step`` refuses it, as eagerly."""
    fused_env("1")
    with capture.stand_in(StandInGraph), mt.cpu():
        rng = np.random.RandomState(0)
        used = mt.gluon.nn.Dense(4, in_units=6)
        used.initialize()
        used.hybridize()
        unused = mt.gluon.nn.Dense(4, in_units=6)
        unused.initialize()
        params = list(used.collect_params().values()) \
            + list(unused.collect_params().values())
        trainer = mt.gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
        x = mt.nd.array(rng.randn(2, 6).astype(np.float32))
        with mt.autograd.record():
            loss = (used(x) ** 2).sum()
        loss.backward()
        with pytest.raises(UserWarning):
            trainer.step(2)
        trainer.step(2, ignore_stale_grad=True)
    assert profiler.counter("graph_replays") == 3


@pytest.mark.parametrize("builder", ["plain", "zero1"])
def test_lm_step_is_one_replay(builder):
    """Both LM step builders: one replay a step after one capture, the
    params, momenta and losses bit for bit with the eager steps."""
    cfg = tr.TransformerLMConfig(vocab=32, d_model=16, n_heads=2, d_ff=32,
                                 n_layers=2, max_len=16)
    init = tr.init_transformer_params(torch.Generator().manual_seed(0),
                                      cfg, device="cpu")
    tok = torch.randint(0, 32, (2, 9),
                        generator=torch.Generator().manual_seed(1))

    def run():
        ps = {n: t.clone() for n, t in init.items()}
        if builder == "plain":
            step = tr.make_train_step(cfg, lr=0.5, device="cpu")
            losses = [step(ps, tok[:, :-1], tok[:, 1:])[1].item()
                      for _ in range(3)]
            return ps, {}, losses
        step, ms = tr.make_train_step_zero1(cfg, ps, lr=0.5)
        losses = [step(ps, ms, tok[:, :-1], tok[:, 1:])[2].item()
                  for _ in range(3)]
        return ps, ms, losses
    with capture.stand_in(StandInGraph):
        got = run()
    assert _counts() == (1, 3, 3)
    want = run()
    assert got[2] == want[2] and want[2][-1] < want[2][0]
    for a, b in zip(got[:2], want[:2]):
        for n in b:
            assert torch.equal(a[n], b[n]), n


def test_cpu_entry_points_never_capture():
    """Without a stand-in, every entry point on the CPU runs eagerly."""
    _fit_module(mt, num_epoch=1)
    _gluon_steps(steps=2)
    cfg = tr.TransformerLMConfig(vocab=32, d_model=16, n_heads=2, d_ff=32,
                                 n_layers=1, max_len=16)
    ps = tr.init_transformer_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    tok = torch.zeros((1, 5), dtype=torch.long)
    tr.make_train_step(cfg, device="cpu")(ps, tok, tok)
    assert profiler.counter("graph_captures") == 0
    assert profiler.counter("graph_replays") == 0
    assert capture.graph_for("cpu") is None
    with capture.stand_in(StandInGraph), capture.eager():
        assert capture.graph_for("cpu") is None
        assert capture.graph_for("cuda") is None
    assert capture.graph_for("cuda") is capture.CudaGraph


def test_failed_capture_raises_and_restores():
    """A capture that fails raises ``MXNetError`` naming the step and the
    cause, runs nothing eagerly in its place and leaves the buffers as
    they were."""
    class Broken(StandInGraph):
        def capture(self, fn):
            fn()
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
    w = torch.ones(3)

    def stage(x):
        with torch.no_grad():
            w.mul_(5.0)
        return [w]
    cache = capture.StepCache("my_step")
    with pytest.raises(MXNetError, match="my_step.*not permitted"):
        cache.program("k", Broken, w.device, lambda: [stage],
                      [torch.ones(1)], [w])
    assert torch.equal(w, torch.ones(3)) and len(cache) == 0
    assert profiler.counter("graph_captures") == 0


def test_capture_pauses_the_garbage_collector():
    """A graph destroyed while another captures breaks that capture, so a
    capture first collects dead programs (here: one in a reference
    cycle, freed before the capture starts) and the collector stays off
    until it ends."""
    import gc
    import weakref
    seen = {}

    class Watching(StandInGraph):
        def capture(self, fn):
            seen["collecting"] = gc.isenabled()
            seen["dead_gone"] = dead() is None
            return super().capture(fn)

    class Cycle:
        pass
    c = Cycle()
    c.me = c
    dead = weakref.ref(c)
    del c
    w = torch.zeros(2)
    capture.Program("gc", Watching, w.device, [lambda x: [x + 1]],
                    [torch.ones(2)], [w])
    assert seen == {"collecting": False, "dead_gone": True}
    assert gc.isenabled()


def _shared_calls(unroll, steps=3):
    """A hybridized net called more than once in each recording, with a
    Trainer step after each backward: twice on two inputs (a
    shared-weight pair), or unrolled three times on its own output (as a
    cell over time steps).  Returns the weights, the gradients, the
    counters' moves per step and the block's slots."""
    with mt.cpu():
        mt.random.seed(0)
        rng = np.random.RandomState(2)
        with mt.name.NameManager():
            net = mt.gluon.nn.HybridSequential()
            with net.name_scope():
                net.add(mt.gluon.nn.Dense(6, activation="tanh", in_units=6))
        net.initialize(init=mt.initializer.Xavier())
        net.hybridize()
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        per_step = []
        for _ in range(steps):
            x1 = mt.nd.array(rng.randn(4, 6).astype(np.float32))
            x2 = mt.nd.array(rng.randn(4, 6).astype(np.float32))
            before = _counts()
            with mt.autograd.record():
                if unroll:
                    h = x1
                    for _ in range(3):
                        h = net(h)
                    loss = (h * x2).sum()
                else:
                    loss = ((net(x1) - net(x2)) ** 2).sum()
            loss.backward()
            trainer.step(4)
            per_step.append(tuple(b - a for a, b in zip(before, _counts())))
        params = list(net.collect_params().values())
        return ([p.data().asnumpy() for p in params],
                [p.grad().asnumpy() for p in params], per_step,
                len(net._cached_op._programs))


@pytest.mark.parametrize("unroll", [False, True])
def test_block_called_twice_in_one_recording(unroll):
    """Each recorded call of a block before its backward has a program of
    its own (the JAX package runs one ``jax.vjp`` a call): the captured
    steps match the eager ones bit for bit, and the next recording
    reuses the programs.  Unrolled, the first call (on data) and the
    later ones (on recorded outputs) differ in what they differentiate,
    so its three calls take two signatures, the second in two slots."""
    with capture.stand_in(StandInGraph):
        got = _shared_calls(unroll)
    want = _shared_calls(unroll)
    # forward and backward graphs of each call's program, then the update
    calls = 3 if unroll else 2
    assert got[2][0] == (2 * calls + 1, 2 * calls + 1, 2 * calls + 1)
    assert got[2][1:] == [(0, 2 * calls + 1, 2 * calls + 1)] * 2
    assert got[3] == 2 and want[3] == 0 and want[2] == [(0, 0, 1)] * 3
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(a, b)


def test_dropped_recording_frees_its_slot():
    """A recorded call whose outputs are dropped before any backward
    gives its slot back: the next recorded call replays the same
    program."""
    with capture.stand_in(StandInGraph), mt.cpu():
        net = mt.gluon.nn.Dense(3, in_units=4)
        net.initialize()
        net.hybridize()
        x = mt.nd.array(np.ones((2, 4), np.float32))
        for _ in range(3):
            with mt.autograd.record():
                out = net(x)
            del out
        assert len(net._cached_op._programs) == 1
        with mt.autograd.record():
            held = [net(x), net(x)]
        assert len(net._cached_op._programs) == 2
        held[0].backward()
        with mt.autograd.record():
            again = net(x)
        again.backward()
        held[1].backward()
    assert profiler.counter("graph_captures") == 4


@pytest.mark.parametrize("op", ["mul", "add"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_traced_16bit_operands_round_once(op, dtype):
    """A traced scalar applied to a 16-bit group (through one flat
    buffer): each element is ``x op h`` in fp32 with the fp32 view of the
    value, rounded once to the operand's type; new tensors and in place,
    groups by shared value kept apart."""
    from mxnet_tpu_torch.optimizer import _Traced, _apply
    gen = torch.Generator().manual_seed(7)
    xs = [torch.randn(s, generator=gen).to(dtype) for s in
          ((5, 3), (7,), (2, 2, 2), (1,))]
    values = torch.tensor([0.1 / 3, 1e-3 * 7 / 3], dtype=torch.float64)
    f32 = values.float()
    hs = [_Traced(values[j], f32[j]) for j in (0, 1)]
    per_slot = [hs[0], hs[1], hs[0], hs[1]]
    fn = torch.mul if op == "mul" else torch.add
    want = [fn(x.float(), h.f32).to(dtype) for x, h in zip(xs, per_slot)]
    got = _apply(op, xs, per_slot)
    inplace = [x.clone() for x in xs]
    _apply(op, inplace, per_slot, inplace=True)
    for w, g, i in zip(want, got, inplace):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, w) and torch.equal(i, w)
