"""``BucketingModule``, the ``Module`` pieces it calls and one graph-memory
pool for a module's captured steps, against the JAX package on the CPU.

Mirrors ``tests/test_module.py::test_bucketing_module`` and
``::test_bucketing_shares_device_params_no_recompile`` (here: no new
capture after the warm-up epoch, counted through the stand-in graph of
``tests/test_torch_capture.py``), and
``tests/test_cached_step.py::test_bucketing_default_bucket_updates_survive_switch``.
The PTB LSTM of ``chip_smoke.py`` (``ptb_sym_gen``, both cell variants)
at a small size trains 3 steps over buckets in the iterator's shuffled
order in both packages from one init: fp64 weights within 1e-10 of the
JAX package's (the same updates summed in other orders; readings near
1e-15), and again with every step captured (stand-in) against eager, bit
for bit.  Each bucket's programs capture into the module's one pool, the
leader's first.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import capture, profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP64_TOL = dict(rtol=0, atol=1e-10)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cap = _load("test_torch_capture", "tests/test_torch_capture.py")
smoke = _load("chip_smoke", "chip_smoke.py")
SMALL = dict(vocab=24, hidden=12, embed=8, layers=2, batch=4,
             buckets=(3, 5, 8))


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


class PoolGraph(cap.StandInGraph):
    """The stand-in graph, recording each graph made and its pool."""
    made, pools = [], []

    def __init__(self, device, pool, generators):
        super().__init__(device, pool, generators)
        PoolGraph.made.append(self)
        PoolGraph.pools.append(pool)

    @staticmethod
    def pool(device):
        return object()


def test_bucketing_module():
    """Shared parameters across per-length buckets (the JAX package's
    test): a forward, backward and update, a switch, the parameters."""
    def sym_gen(seq_len):
        net = mt.sym.FullyConnected(mt.sym.var("data"), num_hidden=8,
                                    name="fc_shared")
        return mt.sym.SoftmaxOutput(net, name="softmax"), ("data",), \
            ("softmax_label",)

    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=10,
                                 context=mt.cpu())
    mod.bind(data_shapes=[("data", (4, 10))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params()
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    b1 = mt.io.DataBatch(
        [mt.nd.ones((4, 10), ctx=mt.cpu())],
        [mt.nd.zeros((4,), ctx=mt.cpu())], bucket_key=10,
        provide_data=[mt.io.DataDesc("data", (4, 10))],
        provide_label=[mt.io.DataDesc("softmax_label", (4,))])
    before = mod.get_params()[0]["fc_shared_weight"].asnumpy().copy()
    mod.forward(b1, is_train=True)
    mod.backward()
    mod.update()
    mod.switch_bucket(10, [mt.io.DataDesc("data", (4, 10))],
                      [mt.io.DataDesc("softmax_label", (4,))])
    arg, _ = mod.get_params()
    assert "fc_shared_weight" in arg
    assert np.abs(arg["fc_shared_weight"].asnumpy() - before).max() > 0


def _toy_iter(pkg, vocab=15, buckets=(4, 6, 8, 10), n=160):
    rng = np.random.RandomState(3)
    sents = []
    for _ in range(n):
        length = rng.choice(buckets) - rng.randint(0, 2)
        start = rng.randint(1, vocab - 1)
        sents.append([(start + t) % (vocab - 1) + 1 for t in range(length)])
    return pkg.rnn.BucketSentenceIter(sents, batch_size=8,
                                      buckets=list(buckets), invalid_label=0)


def _toy_sym_gen(pkg, vocab=15):
    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data, input_dim=vocab, output_dim=8,
                                  name="embed")
        cell = pkg.rnn.LSTMCell(num_hidden=16, prefix="lstm_")
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, 16))
        pred = pkg.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
        lab = pkg.sym.Reshape(label, shape=(-1,))
        pred = pkg.sym.SoftmaxOutput(pred, lab, use_ignore=True,
                                     ignore_label=0, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def test_bucketing_shares_device_params_no_recapture():
    """Every bucket holds the leader's parameter NDArrays themselves; after
    the first epoch (one capture a bucket) two more epochs capture
    nothing and replay every step; it learns across buckets (the JAX
    package's test, with its perplexity bound)."""
    mt.random.seed(0)
    it = _toy_iter(mt)
    mod = mt.mod.BucketingModule(_toy_sym_gen(mt), default_bucket_key=10,
                                 context=mt.cpu())
    with capture.stand_in(cap.StandInGraph):
        before = profiler.counters()
        mod.fit(it, num_epoch=1, optimizer="adam",
                optimizer_params={"learning_rate": 0.01},
                eval_metric=mt.metric.Perplexity(ignore_label=0))
        warm = profiler._delta(before, profiler.counters())
        assert len(mod._by_key) == 4
        assert warm["graph_captures"] == 4
        leader_ex = mod._leader._exec_group.execs[0]
        for key, m in mod._by_key.items():
            assert m._shares_device_params or m is mod._leader
            ex = m._exec_group.execs[0]
            for p in ("embed_weight", "pred_weight", "lstm_i2h_weight"):
                assert ex.arg_dict[p] is leader_ex.arg_dict[p], (key, p)
                assert ex.grad_dict[p] is leader_ex.grad_dict[p], (key, p)
        it.reset()
        before = profiler.counters()
        mod.fit(it, num_epoch=2, optimizer="adam",
                optimizer_params={"learning_rate": 0.01},
                eval_metric=mt.metric.Perplexity(ignore_label=0))
        later = profiler._delta(before, profiler.counters())
    assert later.get("graph_captures", 0) == 0
    assert later["graph_replays"] == later["program_calls"] > 0
    it.reset()
    ppl = mod.score(it, mt.metric.Perplexity(ignore_label=0))[0][1]
    assert ppl < 8.0, ppl


def test_bucketing_default_bucket_updates_survive_switch():
    rng = np.random.RandomState(13)

    def sym_gen(key):
        emb = mt.sym.Embedding(mt.sym.Variable("data"), input_dim=10,
                               output_dim=6, name="emb")
        net = mt.sym.FullyConnected(mt.sym.mean(emb, axis=1), num_hidden=4,
                                    name="fc")
        net = mt.sym.SoftmaxOutput(net, mt.sym.Variable("softmax_label"),
                                   name="softmax")
        return net, ("data",), ("softmax_label",)

    def batch(n, key):
        return mt.io.DataBatch(
            [mt.nd.array(rng.randint(0, 10, (4, n)).astype(np.float32),
                         ctx=mt.cpu())],
            [mt.nd.array(rng.randint(0, 4, (4,)), ctx=mt.cpu())],
            bucket_key=key, provide_data=[mt.io.DataDesc("data", (4, n))],
            provide_label=[mt.io.DataDesc("softmax_label", (4,))])

    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                 context=mt.cpu())
    mod.bind(data_shapes=[mt.io.DataDesc("data", (4, 8))],
             label_shapes=[mt.io.DataDesc("softmax_label", (4,))])
    mod.init_params(initializer=mt.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.5),))
    w = mod._leader._exec_group.execs[0].arg_dict["emb_weight"]
    w0 = w.asnumpy().copy()
    mod._fit_step(batch(8, 8))
    w1 = w.asnumpy().copy()
    assert np.abs(w1 - w0).max() > 0, "leader step had no effect"
    mod._fit_step(batch(5, 5))
    arg, _ = mod.get_params()
    got = arg["emb_weight"].asnumpy()
    assert np.abs(got - w0).max() > 0
    assert np.abs(got - w1).max() > 0, "the second bucket did not update"
    # the leader's own checkpoint sees the second bucket's update
    assert np.array_equal(mod._leader.get_params()[0]["emb_weight"]
                          .asnumpy(), got)


@pytest.mark.parametrize("fused", [False, True], ids=["cells", "fused"])
def test_ptb_lstm_three_steps_against_jax_fp64(fused):
    """chip_smoke's (a) at a small size, both cell variants: 3 steps over
    the iterator's shuffled buckets from one init in both packages, each
    a forward, backward and update.  (The JAX package's one-call step
    rounds lr and wd to fp32 whatever the weights' dtype,
    ``mxnet_tpu/module/cached_step.py:181``, 2e-8 of each update; this
    package's keeps them in fp64, so its one-call step is held against
    its own two-call path below.)"""
    want_batches, _ = smoke.ptb_batches(mx, SMALL, "float64", sentences=60)
    got_batches, _ = smoke.ptb_batches(mt, SMALL, "float64", sentences=60)
    keys = [b.bucket_key for b in got_batches[:3]]
    assert keys == [b.bucket_key for b in want_batches[:3]]
    assert len(set(keys)) > 1
    with mx.cpu():
        want = smoke.ptb_parity_run(mx, mx.cpu(), SMALL, fused,
                                    want_batches[:3], one_call=False)
    got = smoke.ptb_parity_run(mt, mt.cpu(), SMALL, fused, got_batches[:3],
                               one_call=False)
    one_call = smoke.ptb_parity_run(mt, mt.cpu(), SMALL, fused,
                                    got_batches[:3])
    assert sorted(got["params"]) == sorted(want["params"])
    for run in (want, one_call):
        for k in run["params"]:
            np.testing.assert_allclose(got["params"][k], run["params"][k],
                                       err_msg=k, **FP64_TOL)
        for g, w in zip(got["outputs"], run["outputs"]):
            np.testing.assert_allclose(g, w, **FP64_TOL)
        for k in run["grads"]:
            np.testing.assert_allclose(got["grads"][k], run["grads"][k],
                                       err_msg=k, **FP64_TOL)


@pytest.mark.parametrize("fused", [False, True], ids=["cells", "fused"])
def test_shared_pool_captured_against_eager(fused):
    """Every step captured (stand-in) against eager over the buckets in a
    shuffled order, bit for bit; every bucket's program captured into the
    module's one pool, the leader's first, each once."""
    batches, _ = smoke.ptb_batches(mt, SMALL, "float64", sentences=60)
    order = batches[:6]
    assert order[0].bucket_key != max(SMALL["buckets"])
    eager = smoke.ptb_shuffled_run(mt.cpu(), SMALL, fused, order, "eager")
    PoolGraph.made, PoolGraph.pools = [], []
    with capture.stand_in(PoolGraph):
        before = profiler.counters()
        mod = smoke.ptb_module(mt, mt.cpu(), SMALL, fused, dtype="float64")
        outs = []
        for b in order:
            mod._fit_step(b)
            outs.append(mod.get_outputs()[0].asnumpy())
        counts = profiler._delta(before, profiler.counters())
    leader_step = mod._leader._cached_step
    first = next(iter(leader_step._programs._programs.values()))
    assert PoolGraph.made[0] is first._graphs[0]
    keys = {b.bucket_key for b in order} | {max(SMALL["buckets"])}
    assert counts["graph_captures"] == len(keys)
    assert len(PoolGraph.pools) == len(keys)
    assert all(p is PoolGraph.pools[0] for p in PoolGraph.pools)
    assert counts["graph_replays"] == len(order)
    # one set of output buffers for every program of the pool
    progs = [next(iter(m._cached_step._programs._programs.values()))
             for m in mod._by_key.values()]
    assert len({p._outs[0][0].untyped_storage().data_ptr()
                for p in progs}) == 1
    for g, w in zip(outs, eager["outputs"]):
        np.testing.assert_array_equal(g, w)
    got = smoke._param_arrays(mod)
    for k in eager["params"]:
        np.testing.assert_array_equal(got[k], eager["params"][k])


def test_memory_pool_refuses_a_two_stage_program():
    with pytest.raises(mt.MXNetError):
        capture.Program("two", cap.StandInGraph, "cpu",
                        [lambda x: [x], lambda g: [g]],
                        [torch.zeros(2)], [], pool=capture.MemoryPool())


def test_module_reshape_cache_shares_one_pool():
    """A Module's steps at two input shapes capture into one pool."""
    data = mt.sym.Variable("data")
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        mt.sym.sum(data, axis=1), num_hidden=3, name="fc"), name="softmax")
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind([mt.io.DataDesc("data", (4, 5, 2))],
             [mt.io.DataDesc("softmax_label", (4,))])
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer()
    PoolGraph.pools = []
    with capture.stand_in(PoolGraph):
        for t in (5, 7, 5):
            mod._fit_step(mt.io.DataBatch(
                [mt.nd.ones((4, t, 2), ctx=mt.cpu())],
                [mt.nd.zeros((4,), ctx=mt.cpu())]))
    assert len(PoolGraph.pools) == 2
    assert PoolGraph.pools[0] is PoolGraph.pools[1]


def test_module_pieces_against_jax():
    """``set_params(allow_missing=True)``, ``get_input_grads``,
    ``output_shapes`` and ``prepare`` as the JAX package's Module has
    them."""
    got = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        data = pkg.sym.Variable("data")
        net = pkg.sym.FullyConnected(data, num_hidden=3, name="fc")
        net = pkg.sym.SoftmaxOutput(net, name="softmax")
        mod = pkg.mod.Module(net, context=ctx)
        mod.bind([pkg.io.DataDesc("data", (2, 4))],
                 [pkg.io.DataDesc("softmax_label", (2,))],
                 inputs_need_grad=True)
        shapes = mod.output_shapes
        rng = np.random.RandomState(0)
        pkg.random.seed(1)
        mod.init_params(pkg.init.Xavier())
        mod.set_params({"fc_bias": pkg.nd.array(rng.randn(3), ctx=ctx)},
                       {}, allow_missing=True)
        batch = pkg.io.DataBatch(
            [pkg.nd.array(rng.randn(2, 4), ctx=ctx)],
            [pkg.nd.array(np.array([0, 2]), ctx=ctx)])
        mod.prepare(batch)
        mod.forward(batch, is_train=True)
        mod.backward()
        grads = mod.get_input_grads()
        got.append((shapes, grads[0].asnumpy(),
                    mod.get_params()[0]["fc_bias"].asnumpy()))
    assert got[0][0] == got[1][0] == [("softmax_output", (2, 3))]
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[1][2], got[0][2])


def test_bucketing_checkpoint_loads_in_jax(tmp_path):
    """``BucketingModule.save_checkpoint`` writes the leader's symbol and
    the shared parameters; the JAX package's ``Module.load`` reads them
    and scores the same outputs."""
    batches, it = smoke.ptb_batches(mt, SMALL, sentences=40)
    mod = smoke.ptb_module(mt, mt.cpu(), SMALL, fused=True)
    mod._fit_step(batches[0])
    prefix = str(tmp_path / "ptb")
    mod.save_checkpoint(prefix, 1)
    ref = mx.mod.Module.load(prefix, 1, context=mx.cpu())
    top = max(SMALL["buckets"])
    shape = (SMALL["batch"], top)
    ref.bind([mx.io.DataDesc("data", shape)],
             [mx.io.DataDesc("softmax_label", shape)], for_training=False)
    leader = [b for b in batches if b.bucket_key == top][0]
    ref.forward(mx.io.DataBatch([mx.nd.array(leader.data[0].asnumpy())],
                                [mx.nd.array(leader.label[0].asnumpy())]),
                is_train=False)
    mod.forward(leader, is_train=False)
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(),
                               ref.get_outputs()[0].asnumpy(), rtol=1e-5,
                               atol=1e-6)


def test_params_from_jax_carries_the_packed_vector():
    """The JAX package's fused-cell parameters, its packed vector
    unchanged, set into this package's Module: the same outputs."""
    sym_gen = smoke.ptb_sym_gen(mx, SMALL, True)
    ref_sym = sym_gen(5)[0]
    shape = (SMALL["batch"], 5)
    ref = mx.mod.Module(ref_sym, context=mx.cpu())
    ref.bind([mx.io.DataDesc("data", shape)],
             [mx.io.DataDesc("softmax_label", shape)], for_training=False)
    mx.random.seed(2)
    ref.init_params(mx.init.FusedRNN(mx.init.Uniform(0.3)))
    arg, aux = ref.get_params()
    sym = smoke.ptb_sym_gen(mt, SMALL, True)(5)[0]
    descs = [mt.io.DataDesc("data", shape),
             mt.io.DataDesc("softmax_label", shape)]
    args, auxs = mt.mod.params_from_jax(
        {k: v.asnumpy() for k, v in arg.items()}, {}, sym, ctx=mt.cpu(),
        data_shapes=descs)
    assert args["lstm_parameters"].shape == arg["lstm_parameters"].shape
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind(descs[:1], descs[1:], for_training=False)
    mod.set_params(args, auxs)
    x = np.random.RandomState(0).randint(1, SMALL["vocab"], shape)
    ref.forward(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(x)]),
                is_train=False)
    mod.forward(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                [mt.nd.array(x, ctx=mt.cpu())]),
                is_train=False)
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(),
                               ref.get_outputs()[0].asnumpy(), rtol=1e-5,
                               atol=1e-6)


def test_bucketing_without_a_card_raises():
    """On the default context (the card) binding raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = mt.mod.BucketingModule(smoke.ptb_sym_gen(mt, SMALL, False),
                                 default_bucket_key=8)
    with pytest.raises(mt.MXNetError):
        mod.bind([mt.io.DataDesc("data", (4, 8))],
                 [mt.io.DataDesc("softmax_label", (4, 8))])


def test_bucket_that_cannot_share_hands_its_update_back():
    """A bucket bound in another dtype than the leader cannot hold the
    leader's arrays: it takes the leader's values at the switch and hands
    its update back after the step (the JAX package's sync)."""
    def sym_gen(key):
        emb = mt.sym.Embedding(mt.sym.Variable("data"), input_dim=10,
                               output_dim=6, name="emb")
        net = mt.sym.FullyConnected(mt.sym.mean(emb, axis=1), num_hidden=4,
                                    name="fc")
        return mt.sym.SoftmaxOutput(net, mt.sym.Variable("softmax_label"),
                                    name="softmax"), ("data",), \
            ("softmax_label",)

    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                 context=mt.cpu())
    mod.bind([mt.io.DataDesc("data", (4, 8), "float64")],
             [mt.io.DataDesc("softmax_label", (4,), "float64")])
    mod.init_params(initializer=mt.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.5),))
    w0 = mod.get_params()[0]["emb_weight"].asnumpy().copy()
    rng = np.random.RandomState(0)
    mod._fit_step(mt.io.DataBatch(
        [mt.nd.array(rng.randint(0, 10, (4, 5)), ctx=mt.cpu())],
        [mt.nd.array(rng.randint(0, 4, (4,)), ctx=mt.cpu())], bucket_key=5,
        provide_data=[mt.io.DataDesc("data", (4, 5))],
        provide_label=[mt.io.DataDesc("softmax_label", (4,))]))
    bucket = mod._by_key[5]
    assert not bucket._shares_device_params
    got = bucket._exec_group.execs[0].arg_dict["emb_weight"].asnumpy()
    leader = mod._leader._exec_group.execs[0].arg_dict["emb_weight"]
    assert leader.dtype == np.float64 and np.abs(got - w0).max() > 0
    np.testing.assert_allclose(leader.asnumpy(), got, rtol=1e-7)


# -- chip_smoke.py phases 22-23, on the CPU at a small size -------------------
def test_chip_smoke_rnn_dropout_on_the_cpu():
    with capture.stand_in(cap.StandInGraph):
        res = smoke.rnn_dropout_checks(mt.cpu(), shape=(6, 8, 16))
    assert res["replays_differ"] and res["eager_equals_captured"]
    assert res["counts"]["graph_captures"] == 1


@pytest.mark.parametrize("fused", [False, True], ids=["cells", "fused"])
def test_chip_smoke_bucketing_phase_on_the_cpu(fused):
    with capture.stand_in(cap.StandInGraph):
        res = smoke.ptb_bucketing_run(mt.cpu(), fused, cfg=SMALL, steps=8,
                                      sentences=80)
    for mode in ("captured", "eager"):
        assert sorted(res[mode]["ms_median_by_bucket"]) \
            == sorted(SMALL["buckets"])
        assert np.isfinite(res[mode]["perplexity"])
