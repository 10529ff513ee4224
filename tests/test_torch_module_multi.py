"""``Module`` on several contexts (``[cpu(0), cpu(1)]``, one process)
against the JAX package on the CPU: the executor group's batch slices
and ``work_load_list``, the update on the store and on the workers, the
optimizer states through the store, and ``BucketingModule`` with a
workload.

The JAX package's Module takes its fused SPMD group over several
contexts by default (``mxnet_tpu/module/module.py:302-312``); this
package has the per-context group only, so the comparisons run the
reference with ``MXNET_MODULE_FUSED=0`` (its per-context group), and a
stateless net also against its fused default.

Tolerances.  fp64: each context's slice runs the same operations in
both packages, and the store sums two copies (exact in either order of
one pair), so three SGD-momentum steps agree to rounding amplified by
three steps, held to 1e-9 (relative to max(1, |value|)).  Against the
reference's fused group (fp32, a stateless net), the bar of
``tests/test_fused_module.py:56``: rtol 2e-4, atol 2e-5.
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx

import mxnet_tpu_torch as mt

SGD = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))
FP64_TOL = 1e-9
FUSED_RTOL, FUSED_ATOL = 2e-4, 2e-5
BATCH, STEPS = 8, 3


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    """The fp64 runs need JAX's x64 (another test may have turned it off
    in this worker); two torch threads."""
    prev = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_enable_x64", prev[0])
    torch.set_num_threads(prev[1])


@pytest.fixture
def per_context_reference(monkeypatch):
    """The JAX package's per-context executor group."""
    monkeypatch.setenv("MXNET_MODULE_FUSED", "0")


def _bn_net(pkg):
    """conv-BN-ReLU-pool-FC: BatchNorm's batch statistics are each
    slice's own."""
    with pkg.name.NameManager():
        d = pkg.sym.var("data")
        h = pkg.sym.Convolution(d, kernel=(3, 3), num_filter=6, pad=(1, 1),
                                name="c1")
        h = pkg.sym.BatchNorm(h, fix_gamma=False, name="bn1")
        h = pkg.sym.Activation(h, act_type="relu")
        h = pkg.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="avg")
        h = pkg.sym.FullyConnected(h, num_hidden=4, name="fc")
        return pkg.sym.SoftmaxOutput(h, name="softmax")


def _mlp(pkg):
    """The MLP of ``tests/test_module.py``."""
    with pkg.name.NameManager():
        data = pkg.sym.var("data")
        net = pkg.sym.FullyConnected(data, num_hidden=32, name="fc1")
        net = pkg.sym.Activation(net, act_type="relu")
        net = pkg.sym.FullyConnected(net, num_hidden=10, name="fc2")
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def _blob_data(n=600, d=50, k=10, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, k, n)
    centers = rng.randn(k, d).astype(np.float32) * 2
    x = centers[y] + rng.randn(n, d).astype(np.float32) * 0.4
    return x, y.astype(np.float32)


def _ctxs(pkg, n=2):
    return [pkg.cpu(i) for i in range(n)]


def _host(params):
    return [{k: v.asnumpy().astype(np.float64) for k, v in d.items()}
            for d in params]


def _init(symbol_fn, shape, dtype):
    """Xavier parameters from the JAX package, as numpy."""
    mod = mx.mod.Module(symbol_fn(mx), context=mx.cpu())
    mod.bind([mx.io.DataDesc("data", shape, dtype=dtype)],
             [mx.io.DataDesc("softmax_label", shape[:1], dtype=dtype)])
    mx.random.seed(3)
    mod.init_params(mx.init.Xavier())
    return [{k: v.asnumpy().astype(dtype) for k, v in d.items()}
            for d in mod.get_params()]


def _batches(shape, classes, dtype, seed=4):
    rng = np.random.RandomState(seed)
    return [(rng.rand(*shape).astype(dtype),
             rng.randint(0, classes, shape[:1]).astype(dtype))
            for _ in range(STEPS)]


def _train(pkg, symbol_fn, init, batches, ctxs, dtype, kvstore="local",
           work_load_list=None, two_call=False):
    """STEPS steps of ``symbol_fn``'s Module on ``ctxs`` from ``init``:
    returns (the module, each step's merged outputs, the params and aux
    after the last step)."""
    shape = batches[0][0].shape
    mod = pkg.mod.Module(symbol_fn(pkg), context=ctxs,
                         work_load_list=work_load_list)
    mod.bind([pkg.io.DataDesc("data", shape, dtype=dtype)],
             [pkg.io.DataDesc("softmax_label", shape[:1], dtype=dtype)])
    arg, aux = [{k: pkg.nd.array(v, ctx=pkg.cpu(), dtype=dtype)
                 for k, v in d.items()} for d in init]
    mod.set_params(arg, aux)
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=SGD)
    outs = []
    for x, y in batches:
        batch = pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu(),
                                               dtype=dtype)],
                                 [pkg.nd.array(y, ctx=pkg.cpu(),
                                               dtype=dtype)])
        if two_call:
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        else:
            mod._fit_step(batch)
        # the reference cannot join arrays of two devices: join on the host
        outs.append(np.concatenate([
            o.asnumpy() for o in mod.get_outputs(False)[0]]).astype(
                np.float64))
    if pkg is mt:
        np.testing.assert_array_equal(mod.get_outputs()[0].asnumpy(),
                                      outs[-1])
    return (mod, outs) + tuple(_host(mod.get_params()))


def _max_rel(a, b):
    """max |a - b| / max(1, |b|) over dicts or lists of arrays."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        a, b = [a[k] for k in sorted(a)], [b[k] for k in sorted(b)]
    return max(float(np.max(np.abs(x - y) / np.maximum(1.0, np.abs(y))))
               for x, y in zip(a, b))


def test_module_multi_device_data_parallel():
    """``tests/test_module.py::test_module_multi_device_data_parallel``: two
    epochs of ``fit`` over ``[cpu(0), cpu(1)]`` with ``kvstore="local"``
    reach training-set accuracy above 0.9."""
    x, y = _blob_data(n=400)
    train = mt.io.NDArrayIter(x, y, batch_size=40, shuffle=True)
    mod = mt.mod.Module(_mlp(mt), context=_ctxs(mt))
    mod.fit(train, num_epoch=2, kvstore="local",
            optimizer_params={"learning_rate": 0.2, "momentum": 0.9})
    assert len(mod._exec_group.execs) == 2
    assert mod._update_on_kvstore and mod._kvstore.type == "local"
    score = mod.score(mt.io.NDArrayIter(x, y, batch_size=40), "acc")
    assert score[0][1] > 0.9, score


@pytest.mark.parametrize("work_load_list", [None, [1, 3]],
                         ids=["even", "workload_1_3"])
@pytest.mark.parametrize("kvstore", ["local", "device"])
def test_bn_net_three_steps_fp64_match_reference(per_context_reference,
                                                 kvstore, work_load_list):
    """Three fit steps in fp64 on ``[cpu(0), cpu(1)]`` (BatchNorm's
    statistics per slice), evenly and at ``work_load_list=[1, 3]``:
    outputs, weights and each context's moving statistics (their mean,
    as ``get_params`` gives it) equal the reference's per-context group
    at ``FP64_TOL``."""
    shape = (BATCH, 3, 8, 8)
    init = _init(_bn_net, shape, "float64")
    batches = _batches(shape, 4, "float64")
    got = _train(mt, _bn_net, init, batches, _ctxs(mt), "float64", kvstore,
                 work_load_list)
    want = _train(mx, _bn_net, init, batches, _ctxs(mx), "float64", kvstore,
                  work_load_list)
    slices = [s.stop - s.start for s in got[0]._exec_group.slices]
    assert slices == ([2, 6] if work_load_list else [4, 4])
    assert [s.stop - s.start for s in want[0]._exec_group.slices] == slices
    assert _max_rel(got[1], want[1]) <= FP64_TOL
    assert _max_rel(got[2], want[2]) <= FP64_TOL
    assert _max_rel(got[3], want[3]) <= FP64_TOL
    # the slices' own statistics: the contexts' moving means differ
    means = [a.asnumpy() for a in got[0]._exec_group.aux_arrays[0]]
    assert not np.array_equal(means[0], means[1])


def test_stateless_net_matches_reference_fused_default(monkeypatch):
    """A stateless net (the MLP) in fp32 on ``[cpu(0), cpu(1)]``: equal to
    the reference's default fused SPMD group at its own bar against its
    per-context group (``tests/test_fused_module.py:56``)."""
    monkeypatch.delenv("MXNET_MODULE_FUSED", raising=False)
    shape = (BATCH, 50)
    init = _init(_mlp, shape, "float32")
    x, y = _blob_data(n=BATCH * STEPS)
    batches = [(x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH])
               for i in range(STEPS)]
    got = _train(mt, _mlp, init, batches, _ctxs(mt), "float32")
    want = _train(mx, _mlp, init, batches, _ctxs(mx), "float32")
    from mxnet_tpu.module.fused_group import FusedExecutorGroup
    assert isinstance(want[0]._exec_group, FusedExecutorGroup)
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=FUSED_RTOL,
                                   atol=FUSED_ATOL, err_msg=k)


@pytest.mark.parametrize("kvstore", ["device", "local", None,
                                     "kvstore_instance"])
def test_update_placement_matches_reference(per_context_reference, kvstore):
    """Both placements of the update, through the two-call path in fp64:
    a name (update on the store), a ``KVStore`` instance (on the store
    always) and None (no store: the local updater on each context's copy
    of its own slice's gradient), against the reference."""
    shape = (BATCH, 50)
    init = _init(_mlp, shape, "float64")
    x, y = _blob_data(n=BATCH * STEPS)
    batches = [(x[i * BATCH:(i + 1) * BATCH].astype("float64"),
                y[i * BATCH:(i + 1) * BATCH].astype("float64"))
               for i in range(STEPS)]
    res = []
    for pkg in (mt, mx):
        kv = pkg.kv.create("device") if kvstore == "kvstore_instance" \
            else kvstore
        res.append(_train(pkg, _mlp, init, batches, _ctxs(pkg), "float64",
                          kv, two_call=True))
    got, want = res
    on_store = kvstore is not None
    assert got[0]._update_on_kvstore == want[0]._update_on_kvstore == on_store
    assert (got[0]._updater is None) == on_store
    assert _max_rel(got[1], want[1]) <= FP64_TOL
    assert _max_rel(got[2], want[2]) <= FP64_TOL


def test_local_store_updates_on_workers_past_16m_elements():
    """``model._create_kvstore``'s rules, as the reference's: one context
    with a name takes no store; ``local`` updates on the store up to 16M
    elements and on the workers past them; an instance always on the
    store; ``dist_sync`` without a launcher is a local store."""
    from mxnet_tpu_torch.model import _create_kvstore
    small = {"w": mt.nd.zeros((4, 4), ctx=mt.cpu())}

    class Big:
        shape = (4097, 4096)

    for spec, n, params, want in (("device", 1, small, (False, False)),
                                  ("local", 1, small, (False, False)),
                                  ("local", 2, small, (True, True)),
                                  ("device", 2, {"w": Big}, (True, True)),
                                  ("local", 2, {"w": Big}, (True, False)),
                                  ("dist_sync", 1, small, (True, True)),
                                  (None, 2, small, (False, False))):
        kv, on_store = _create_kvstore(spec, n, params)
        assert (kv is not None, on_store) == want, spec
    inst = mt.kv.create("local")
    assert _create_kvstore(inst, 1, small) == (inst, True)
    with pytest.raises(TypeError):
        _create_kvstore(3, 2, small)


def test_optimizer_states_through_the_store(tmp_path):
    """With the update on the store, ``save_optimizer_states`` writes the
    store's Updater (the momenta keyed by parameter name, as the
    reference's file is), the reference reads it, and a fresh module
    that loads it continues as the uninterrupted run does."""
    shape = (BATCH, 50)
    init = _init(_mlp, shape, "float64")
    x, y = _blob_data(n=BATCH * (STEPS + 1))
    batches = [(x[i * BATCH:(i + 1) * BATCH].astype("float64"),
                y[i * BATCH:(i + 1) * BATCH].astype("float64"))
               for i in range(STEPS + 1)]
    mod, _, arg, aux = _train(mt, _mlp, init, batches[:STEPS], _ctxs(mt),
                              "float64", "device")
    fname = str(tmp_path / "mlp.states")
    mod.save_optimizer_states(fname)
    with open(fname, "rb") as fh:
        blob = fh.read()
    states = mx.optimizer.get_updater(mx.optimizer.SGD())
    states.set_states(blob)
    assert sorted(states.states) == sorted(mod._exec_group.param_names)

    def last_step(m):
        xb, yb = batches[STEPS]
        m._fit_step(mt.io.DataBatch([mt.nd.array(xb, ctx=mt.cpu(),
                                                 dtype="float64")],
                                    [mt.nd.array(yb, ctx=mt.cpu(),
                                                 dtype="float64")]))
        return _host(m.get_params())[0]

    resumed = mt.mod.Module(_mlp(mt), context=_ctxs(mt))
    resumed.bind([mt.io.DataDesc("data", shape, dtype="float64")],
                 [mt.io.DataDesc("softmax_label", shape[:1],
                                 dtype="float64")])
    resumed.set_params(*[{k: mt.nd.array(v, ctx=mt.cpu(), dtype="float64")
                          for k, v in d.items()} for d in (arg, aux)])
    resumed.init_optimizer(kvstore="device", optimizer="sgd",
                           optimizer_params=SGD)
    resumed.load_optimizer_states(fname)
    want = last_step(mod)
    got = last_step(resumed)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bucketing_module_with_work_load_list(per_context_reference):
    """``BucketingModule`` on ``[cpu(0), cpu(1)]`` with ``work_load_list``:
    each bucket splits its batch by the workload, the buckets share the
    parameters, and two steps on two buckets equal the reference's in
    fp64."""
    def sym_gen_for(pkg):
        def sym_gen(seq_len):
            with pkg.name.NameManager():
                net = pkg.sym.FullyConnected(pkg.sym.var("data"),
                                             num_hidden=6, name="fc_shared")
                net = pkg.sym.SoftmaxOutput(net, name="softmax")
            return net, ("data",), ("softmax_label",)
        return sym_gen

    rng = np.random.RandomState(6)
    w = rng.randn(6, 5) * 0.1
    b = np.zeros(6)
    data = [(rng.randn(8, 5), rng.randint(0, 6, 8).astype(np.float64))
            for _ in range(2)]
    res = []
    for pkg in (mt, mx):
        mod = pkg.mod.BucketingModule(sym_gen_for(pkg), default_bucket_key=10,
                                      context=_ctxs(pkg),
                                      work_load_list=[3, 1])
        desc = [pkg.io.DataDesc("data", (8, 5), dtype="float64")]
        ldesc = [pkg.io.DataDesc("softmax_label", (8,), dtype="float64")]
        mod.bind(desc, ldesc)
        mod.init_params(arg_params={
            "fc_shared_weight": pkg.nd.array(w, ctx=pkg.cpu(),
                                             dtype="float64"),
            "fc_shared_bias": pkg.nd.array(b, ctx=pkg.cpu(),
                                           dtype="float64")},
            aux_params={})
        mod.init_optimizer(kvstore="device",
                           optimizer_params=(("learning_rate", 0.1),))
        for key, (x, y) in zip((10, 7), data):
            mod.forward(pkg.io.DataBatch(
                [pkg.nd.array(x, ctx=pkg.cpu(), dtype="float64")],
                [pkg.nd.array(y, ctx=pkg.cpu(), dtype="float64")],
                bucket_key=key, provide_data=desc, provide_label=ldesc),
                is_train=True)
            mod.backward()
            mod.update()
        res.append((mod, _host(mod.get_params())[0]))
    (port, got), (_, want) = res
    assert [s.stop - s.start
            for s in port._active._exec_group.slices] == [6, 2]
    assert _max_rel(got, want) <= FP64_TOL


# -- chip_smoke.py phase 30 (b), on the CPU at a small size -------------------
def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_two_context_mlp_on_the_cpu(monkeypatch):
    """Phase 30 (b)'s runs on two CPU contexts in either order, 4 steps:
    the MLP through Module (workload 3:1, the update on the store) and
    through Gluon (``split_and_load``, ``Trainer(kvstore="device")``)
    agree at the phase's bars, and the loss falls."""
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "KV_MLP_STEPS", 4)
    smoke.register_pl_scale()
    batches = smoke._kv_mlp_batches(mt)
    ab, ba = [mt.cpu(0), mt.cpu(1)], [mt.cpu(1), mt.cpu(0)]
    runs = [smoke.kv_mlp_module(c, kv, batches)
            for c, kv in ((ab, "device"), (ba, "local"))]
    assert all(r["slices"] == [48, 16] and r["on_store"] for r in runs)
    gluon = [smoke.kv_mlp_gluon(c, batches) for c in (ab, ba)]
    for a, b in (runs, gluon):
        loss, w = smoke._kv_mlp_gaps(a, b)
        assert loss <= smoke.KV_MLP_LOSS_TOL and w <= smoke.KV_MLP_W_TOL
        assert a["losses"][-1] < a["losses"][0]
