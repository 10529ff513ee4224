"""``Module`` and ``CachedTrainStep`` of the PyTorch package against the
JAX package on the CPU: ``_fit_step`` on the Gluon ResNet-18 (thumbnail,
10 classes) from parameters carried across by ``params_from_jax``, the
fused step against the two-call path, the ``fit``/``score``/``predict``
loop over ``NDArrayIter``, the optimizer's per-parameter rules and
update counts, and the refusals.

Tolerances.  One SGD step (lr 0.1, momentum 0.9) on a batch of 2 makes
the next steps depend on the rounding of the first: a ReLU input within
rounding of zero takes the other branch, and the difference grows from
there: after three steps the two packages' fp64 runs are 3.6e-8 apart
(the first step's outputs 1.7e-15), so the fp64 trajectories are held
to 1e-6.  In fp32 the first step's outputs (no
update yet) are held to 1e-4, and the later steps to four times the
distance rounding alone puts between the JAX package's own fp32 and fp64
runs.  The fused step and the two-call path of this package run the
same operations in the same order: rtol 2e-5, atol 1e-6, the bar
``tests/test_cached_step.py`` sets the JAX package.
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError

SHAPE, CLASSES, STEPS = (2, 3, 32, 32), 10, 3
SGD = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))
FP64_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    """The JAX package turns x64 on at import; another test may have
    turned it off in this worker.  Two torch threads: the suite runs
    several workers on one machine."""
    prev = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_enable_x64", prev[0])
    torch.set_num_threads(prev[1])


def _symbol(pkg, dtype):
    with pkg.name.NameManager():
        net = pkg.gluon.model_zoo.vision.get_model(
            "resnet18_v1", thumbnail=True, classes=CLASSES)
    if dtype != "float32":
        net.cast(dtype)
    return pkg.sym.SoftmaxOutput(net(pkg.sym.var("data")),
                                 pkg.sym.var("softmax_label"),
                                 name="softmax")


def _bench_symbol(pkg):
    """``bench.py``'s lowering: the bf16 net, ``Cast`` to fp32, then the
    softmax (labels float32)."""
    with pkg.name.NameManager():
        net = pkg.gluon.model_zoo.vision.get_model(
            "resnet18_v1", thumbnail=True, classes=CLASSES)
    net.cast("bfloat16")
    out = pkg.sym.Cast(net(pkg.sym.var("data")), dtype="float32")
    return pkg.sym.SoftmaxOutput(out, pkg.sym.var("softmax_label"),
                                 name="softmax")


def _module(pkg, dtype, ctx):
    mod = pkg.mod.Module(_symbol(pkg, dtype), context=ctx)
    mod.bind(data_shapes=[pkg.io.DataDesc("data", SHAPE, dtype=dtype)],
             label_shapes=[pkg.io.DataDesc("softmax_label", SHAPE[:1],
                                           dtype=dtype)])
    return mod


def _batches(pkg, dtype, ctx):
    rng = np.random.RandomState(5)
    out = []
    for _ in range(STEPS):
        x = rng.rand(*SHAPE).astype(np.float32)
        y = rng.randint(0, CLASSES, SHAPE[:1]).astype(np.float32)
        out.append(pkg.io.DataBatch(
            [pkg.nd.array(x, ctx=ctx, dtype=dtype)],
            [pkg.nd.array(y, ctx=ctx, dtype=dtype)]))
    return out


def _host(params):
    return [{k: v.asnumpy().astype(np.float64) for k, v in d.items()}
            for d in params]


def _run(pkg, dtype, init):
    """STEPS ``_fit_step``s from ``init`` (numpy arg, aux); returns (the
    module, each step's outputs, the params and the aux after the
    last)."""
    ctx = pkg.cpu()
    mod = _module(pkg, dtype, ctx)
    arg, aux = [{k: v.astype(dtype) for k, v in d.items()} for d in init]
    if pkg is mt:
        arg, aux = mt.mod.params_from_jax(arg, aux, mod.symbol, ctx=ctx,
                                          data_shapes=mod.data_shapes)
    else:
        arg, aux = [{k: mx.nd.array(v, dtype=dtype) for k, v in d.items()}
                    for d in (arg, aux)]
    mod.set_params(arg, aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    outs = []
    for batch in _batches(pkg, dtype, ctx):
        mod._fit_step(batch)
        outs.append(mod.get_outputs()[0].asnumpy().astype(np.float64))
    return (mod, outs) + tuple(_host(mod.get_params()))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's runs from one Xavier init, in fp64 and fp32."""
    mod = _module(mx, "float32", mx.cpu())
    mx.random.seed(0)
    mod.init_params(mx.init.Xavier())
    init = _host(mod.get_params())
    return init, {dt: _run(mx, dt, init) for dt in ("float64", "float32")}


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """This package's runs from the same init, in fp64 and fp32."""
    init, _ = jax_runs
    return {dt: _run(mt, dt, init) for dt in ("float64", "float32")}


def _diffs(a, b):
    (oa, pa, xa), (ob, pb, xb) = a, b
    d = {"out%d" % i: np.abs(x - y).max() for i, (x, y) in
         enumerate(zip(oa, ob), 1)}
    d["params"] = max(np.abs(pa[k] - pb[k]).max() for k in pa)
    d["aux"] = max(np.abs(xa[k] - xb[k]).max() for k in xa)
    return d


def test_fit_steps_fp64_match_jax(jax_runs, port_runs):
    _, ref = jax_runs
    mod, outs, arg, aux = port_runs["float64"]
    assert mod._cached_step is not None
    diffs = _diffs((outs, arg, aux), ref["float64"][1:])
    assert max(diffs.values()) < FP64_ATOL, diffs


def test_fit_steps_fp32_match_jax(jax_runs, port_runs):
    _, ref = jax_runs
    _, outs, arg, aux = port_runs["float32"]
    diffs = _diffs((outs, arg, aux), ref["float32"][1:])
    spread = _diffs(ref["float32"][1:], ref["float64"][1:])
    assert diffs["out1"] < 1e-4, diffs
    for k in diffs:
        if k != "out1":
            assert diffs[k] <= 4 * spread[k] + 1e-6, (k, diffs, spread)


def test_bfloat16_types_and_first_step(jax_runs):
    """After ``net.cast("bfloat16")`` every argument and aux state binds as
    bf16 and ``Cast`` gives fp32 (``infer_type`` as in the JAX package);
    the first step's outputs (no update yet) stay within 2^-6 of the JAX
    package's fp64 run: every layer rounds its activations to bf16 (unit
    2^-8), measured 0.0039 against the JAX package's bf16 run."""
    init, ref = jax_runs
    types = []
    for pkg in (mx, mt):
        groups = _bench_symbol(pkg).infer_type(data="bfloat16")
        types.append([{str(t).replace("torch.", "") for t in g}
                      for g in groups])
    assert types[0] == types[1] == [{"bfloat16", "float32"}, {"float32"},
                                    {"bfloat16"}]
    mod, outs, _, _ = _run(mt, "bfloat16", init)
    ex = mod._exec_group.execs[0]
    assert {str(a._data.dtype) for a in ex.aux_arrays} == {"torch.bfloat16"}
    assert mod._cached_step is not None
    np.testing.assert_allclose(outs[0], ref["float64"][1][0],
                               atol=2.0 ** -6, rtol=0)
    assert all(np.isfinite(o).all() for o in outs)


def test_optimizer_rules_and_update_counts_match_jax(jax_runs, port_runs):
    """lr/wd multipliers per parameter (Gluon's variables carry
    ``__wd_mult__`` 1.0, so biases and betas decay too, as in the JAX
    package), rescale_grad 1/batch, and the update counts."""
    _, ref = jax_runs
    jopt = ref["float64"][0]._optimizer
    opt = port_runs["float64"][0]._optimizer
    assert opt.rescale_grad == jopt.rescale_grad == 1.0 / SHAPE[0]
    for idx, name in opt.idx2name.items():
        assert jopt.idx2name[idx] == name
        assert opt._get_lr(idx) == jopt._get_lr(idx), name
        assert opt._get_wd(idx) == jopt._get_wd(idx), name
    assert opt._index_update_count == jopt._index_update_count
    assert opt.num_update == jopt.num_update == STEPS


def test_fused_step_matches_two_call_path(monkeypatch, jax_runs, port_runs):
    init, _ = jax_runs
    fast = port_runs["float32"]
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "0")
    slow = _run(mt, "float32", init)
    assert fast[0]._cached_step is not None and slow[0]._cached_step is None
    for a, b in zip(fast[1], slow[1]):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6)
    for da, db in zip(fast[2:], slow[2:]):
        for k in da:
            np.testing.assert_allclose(da[k], db[k], rtol=2e-5, atol=1e-6,
                                       err_msg=k)
    assert fast[0]._optimizer._index_update_count == \
        slow[0]._optimizer._index_update_count


def _small_net(pkg):
    """conv-BN-ReLU-pool-FC through the Symbol API."""
    with pkg.name.NameManager():
        d = pkg.sym.var("data")
        h = pkg.sym.Convolution(d, kernel=(3, 3), num_filter=6, pad=(1, 1),
                                name="c1")
        h = pkg.sym.BatchNorm(h, fix_gamma=False, name="bn1")
        h = pkg.sym.Activation(h, act_type="relu")
        h = pkg.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="avg")
        h = pkg.sym.FullyConnected(h, num_hidden=4, name="fc")
        return pkg.sym.SoftmaxOutput(h, name="softmax")


def _fit_and_score(pkg, x, y, init, epochs=2):
    ctx = pkg.cpu()
    train = pkg.io.NDArrayIter(x, y, batch_size=8)
    mod = pkg.mod.Module(_small_net(pkg), context=ctx)
    if pkg is mt:
        mod.bind(train.provide_data, train.provide_label)
        arg, aux = mt.mod.params_from_jax(*init, mod.symbol, ctx=ctx,
                                          data_shapes=train.provide_data)
    else:
        arg, aux = [{k: mx.nd.array(v, dtype=v.dtype) for k, v in d.items()}
                    for d in init]
    metric = pkg.metric.Accuracy()
    mod.fit(train, eval_metric=metric, optimizer="sgd", optimizer_params=SGD,
            arg_params=arg, aux_params=aux, num_epoch=epochs)
    train_acc = metric.get()[1]
    # batches of 4 where the module is bound at 8: forward rebinds
    score = mod.score(pkg.io.NDArrayIter(x, y, batch_size=4),
                      pkg.metric.Accuracy())
    pred = mod.predict(pkg.io.NDArrayIter(x[:13], y[:13], batch_size=8))
    return train_acc, score, pred.asnumpy(), _host(mod.get_params())


def test_fit_loop_score_and_predict_match_jax():
    """``fit`` for 2 epochs over an NDArrayIter, ``score`` with Accuracy at
    another batch size (the module rebinds) and ``predict`` (the padded
    last batch trimmed), fp32 (the iterator
    makes float64 arrays float32, in both packages).  A batch of 8 and
    one conv layer keep the trajectories within 1e-5."""
    rng = np.random.RandomState(9)
    x = rng.rand(32, 3, 8, 8)
    y = rng.randint(0, 4, (32,)).astype(np.float64)
    jmod = mx.mod.Module(_small_net(mx), context=mx.cpu())
    jmod.bind([("data", (8, 3, 8, 8))], [("softmax_label", (8,))])
    mx.random.seed(1)
    jmod.init_params(mx.init.Xavier())
    init = [{k: v.asnumpy() for k, v in d.items()} for d in jmod.get_params()]
    want = _fit_and_score(mx, x, y, init)
    got = _fit_and_score(mt, x, y, init)
    assert got[0] == want[0]
    assert got[1] == want[1] and got[1][0][0] == "accuracy"
    assert got[2].shape == (13, 4)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=0)
    for a, b in zip(got[3], want[3]):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0,
                                       err_msg=k)


def test_default_context_and_refusals(monkeypatch):
    """A Module without a context takes gpu(0) (with no card that raises,
    no move to the CPU); two contexts bind two executors, each on its half
    of the batch; ``kvstore="dist_sync"`` without a launcher is a local
    store on which the update runs, as in the JAX package, and with
    ``DMLC_ROLE`` set it raises naming A.10 (the distributed store); an
    unknown optimizer raises."""
    s = _small_net(mt)
    if torch.cuda.is_available():
        assert mt.mod.Module(s)._context == [mt.gpu(0)]
    else:
        with pytest.raises(MXNetError):
            mt.mod.Module(s)
    mod = mt.mod.Module(s, context=[mt.cpu(0), mt.cpu(1)])
    mod.bind([("data", (8, 3, 8, 8))], [("softmax_label", (8,))])
    execs = mod._exec_group.execs
    assert [e._ctx for e in execs] == [mt.cpu(0), mt.cpu(1)]
    assert [e.arg_dict["data"].shape[0] for e in execs] == [4, 4]
    monkeypatch.delenv("DMLC_ROLE", raising=False)
    stores = []
    for pkg in (mt, mx):
        one = pkg.mod.Module(_small_net(pkg), context=pkg.cpu())
        one.bind([("data", (8, 3, 8, 8))], [("softmax_label", (8,))])
        one.init_params(pkg.init.Xavier())
        one.init_optimizer(kvstore="dist_sync")
        stores.append((one._kvstore.type, one._update_on_kvstore,
                       one._updater is None))
    assert stores[0] == stores[1] == ("dist_sync", True, True)
    mod = mt.mod.Module(s, context=mt.cpu())
    mod.bind([("data", (8, 3, 8, 8))], [("softmax_label", (8,))])
    mod.init_params(mt.init.Xavier())
    monkeypatch.setenv("DMLC_ROLE", "worker")
    with pytest.raises(MXNetError, match="A.10"):
        mod.init_optimizer(kvstore="dist_sync")
    monkeypatch.delenv("DMLC_ROLE")
    with pytest.raises(MXNetError):
        mod.init_optimizer(optimizer="no_such_optimizer")
    mod.init_optimizer(optimizer="adam")  # ported since the Gluon slice
    assert isinstance(mod._optimizer, mt.optimizer.Adam)


def test_init_params_fills_bf16_as_the_jax_package():
    """``Module.init_params(Xavier())`` on the bf16 net: weights are
    uniform within +-sqrt(3 / avg(fan_in, fan_out)) rounded to bf16, as
    the JAX package's are (the draws differ: numpy there, the device's
    generator here); Gluon's ``__init__`` attrs make gamma and the running
    variance ones, beta, biases and running means zeros, in both."""
    name = "resnetv10_stage1_conv2d0_weight"
    filled = []
    for pkg in (mx, mt):
        mod = pkg.mod.Module(_bench_symbol(pkg), context=pkg.cpu())
        mod.bind(data_shapes=[pkg.io.DataDesc("data", SHAPE,
                                              dtype="bfloat16")],
                 label_shapes=[pkg.io.DataDesc("softmax_label", SHAPE[:1])])
        mod.init_params(pkg.init.Xavier())
        arg, aux = mod.get_params()
        filled.append({k: v.asnumpy().astype(np.float32)
                       for k, v in list(arg.items()) + list(aux.items())})
        assert "bfloat16" in str(arg[name].dtype)
    for values in filled:
        w = values[name]
        fan_in, fan_out = w.shape[1] * 9, w.shape[0] * 9
        sigma = np.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
        assert np.abs(w).max() <= sigma * (1 + 2 ** -8) and w.std() > 0
        bf16 = mt.nd.array(w, ctx=mt.cpu(), dtype="bfloat16").asnumpy()
        np.testing.assert_array_equal(bf16, w)  # on the bf16 grid
        for suffix, value in (("gamma", 1), ("running_var", 1), ("beta", 0),
                              ("running_mean", 0), ("dense0_bias", 0)):
            assert all((v == value).all() for k, v in values.items()
                       if k.endswith(suffix)), suffix
    assert filled[0].keys() == filled[1].keys()
