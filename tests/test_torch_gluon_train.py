"""Gluon training of the PyTorch package against the JAX package on the
CPU: the losses, ``hybridize()`` (the cached graph), ``Trainer`` with
its fused and per-parameter steps, the stale-gradient rule, ``utils``
and ``SymbolBlock``, on the same numpy inputs and seeds in both
packages.

Tolerances, relative to max(1, |v|): every loss's value and gradient,
and the Dense-net Trainer runs after 5 steps, 1e-12 in fp64 and 1e-6 in
fp32.  The fp64 Trainer runs are held to the JAX package's per-parameter
loop (``MXNET_FUSED_TRAINER=0``, its own bit-for-bit oracle), which the
port's two paths both equal to a few ulps: the JAX package's fused step
rounds each learning rate and weight decay to fp32 before the update
(``hyper`` arrays in ``fused_trainer.run_fused_step``), which moves its
fp64 runs 5e-10 to 7e-9 from its own loop (measured here with this
file's nets and optimizers); in fp32 its two paths are equal.  The
thumbnail ResNet-18 (``tests/test_torch_gluon_resnet.py``'s
``thumbnail18`` net) is held to ``tests/test_torch_module.py``'s bars:
fp64 1e-6 over 3 steps (two steps at lr 0.1 on a batch of 2 amplify
rounding), fp32 step-1 outputs 1e-4; and one Gluon step against the
port's own Module step in fp64 to 1e-12 (softmax of the logits against
Module's probabilities) and 1e-10 (the parameters).  Inside the port,
the fused and per-parameter Trainer paths agree bit for bit, and a
hybridized block traces once per signature.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx
from mxnet_tpu.gluon import fused_trainer as jax_fused

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon import block as port_block
from mxnet_tpu_torch.gluon import fused_trainer as port_fused

TOL = {"float64": 1e-12, "float32": 1e-6}
THUMB_CLASSES = 10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


gluon_resnet_tests = _load("test_torch_gluon_resnet",
                           "tests/test_torch_gluon_resnet.py")


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    """x64 for the JAX package's fp64 runs (another test in this worker
    may have turned it off); two torch threads, as several workers share
    the machine."""
    prev = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_enable_x64", prev[0])
    torch.set_num_threads(prev[1])


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


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)
                        / np.maximum(1.0, np.abs(b))))


def _max_rel(a, b):
    return max(_rel(x, y) for x, y in zip(a, b))


# -- losses ------------------------------------------------------------------
def _loss_blocks(pkg):
    L = pkg.gluon.loss
    return {
        "l2": (L.L2Loss(), "reg"), "l1": (L.L1Loss(), "reg"),
        "huber": (L.HuberLoss(rho=0.5), "reg"),
        "hinge": (L.HingeLoss(), "sign"),
        "squared_hinge": (L.SquaredHingeLoss(), "sign"),
        "bce": (L.SigmoidBinaryCrossEntropyLoss(), "bin"),
        "bce_from_sigmoid": (L.SigmoidBCELoss(from_sigmoid=True), "prob"),
        "softmax_ce": (L.SoftmaxCrossEntropyLoss(), "cls"),
        "softmax_ce_dense": (L.SoftmaxCELoss(sparse_label=False), "dist"),
        "softmax_ce_from_logits": (L.SoftmaxCrossEntropyLoss(
            from_logits=True), "logp"),
        "kl_div": (L.KLDivLoss(), "kl"),
        "l2_weighted": (L.L2Loss(weight=0.7), "weighted"),
    }


def _loss_inputs(kind, dtype, seed=0):
    rng = np.random.RandomState(seed)
    pred = rng.randn(4, 5)
    label = {"reg": rng.randn(4, 5), "sign": np.sign(rng.randn(4, 5)),
             "bin": (rng.rand(4, 5) > .5) * 1.0,
             "prob": (rng.rand(4, 5) > .5) * 1.0,
             "cls": np.array([1, 0, 2, 4]), "logp": np.array([1, 0, 2, 4]),
             "dist": rng.rand(4, 5), "kl": rng.rand(4, 5),
             "weighted": rng.randn(4, 5)}[kind]
    if kind in ("dist", "kl"):
        label = label / label.sum(1, keepdims=True)
    if kind == "prob":
        pred = 1 / (1 + np.exp(-pred))
    if kind == "logp":
        pred = pred - np.log(np.exp(pred).sum(1, keepdims=True))
    extra = [rng.rand(4, 1)] if kind == "weighted" else []
    return [a.astype(dtype) for a in [pred, label] + extra]


def _loss_run(pkg, name, dtype, hybridize):
    blk, kind = _loss_blocks(pkg)[name]
    if hybridize:
        blk.hybridize()
    with pkg.cpu():
        arrays = [pkg.nd.array(a, dtype=dtype)
                  for a in _loss_inputs(kind, dtype)]
        arrays[0].attach_grad()
        with pkg.autograd.record():
            loss = blk(*arrays)
        loss.backward()
        return loss.asnumpy(), arrays[0].grad.asnumpy()


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", list(_loss_blocks(mt)))
def test_losses(name, dtype, hybridize):
    """Each loss's value and its gradient in the prediction, imperative and
    hybridized, against the JAX package's imperative loss."""
    val, grad = _loss_run(mt, name, dtype, hybridize)
    jval, jgrad = _loss_run(mx, name, dtype, False)
    assert val.shape == jval.shape == (4,)
    assert _rel(val, jval) <= TOL[dtype]
    assert _rel(grad, jgrad) <= TOL[dtype]


def test_losses_match_numpy():
    """``tests/test_gluon.py::test_losses``: L1, L2 and softmax CE against
    numpy."""
    rng = np.random.RandomState(1)
    p = rng.randn(4, 5).astype("float32")
    lab = rng.randn(4, 5).astype("float32")
    cls = np.array([1, 0, 2, 4], np.float32)
    with mt.cpu():
        pred, label = mt.nd.array(p), mt.nd.array(lab)
        l1 = mt.gluon.loss.L1Loss()(pred, label).asnumpy()
        l2 = mt.gluon.loss.L2Loss()(pred, label).asnumpy()
        sce = mt.gluon.loss.SoftmaxCrossEntropyLoss()(
            pred, mt.nd.array(cls)).asnumpy()
    np.testing.assert_allclose(l1, np.abs(p - lab).mean(axis=1), rtol=1e-5)
    np.testing.assert_allclose(l2, 0.5 * ((p - lab) ** 2).mean(axis=1),
                               rtol=1e-5)
    logp = p - p.max(1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(1, keepdims=True))
    np.testing.assert_allclose(sce, -logp[np.arange(4), cls.astype(int)],
                               rtol=1e-4)


def test_bce_loss():
    rng = np.random.RandomState(2)
    p = rng.randn(4, 3).astype("float32")
    lab = (rng.rand(4, 3) > 0.5).astype("float32")
    res = []
    for pkg in (mt, mx):
        with pkg.cpu():
            res.append(pkg.gluon.loss.SigmoidBinaryCrossEntropyLoss()(
                pkg.nd.array(p), pkg.nd.array(lab)).asnumpy())
    expected = (np.maximum(p, 0) - p * lab
                + np.log1p(np.exp(-np.abs(p)))).mean(axis=1)
    np.testing.assert_allclose(res[0], expected, rtol=1e-4, atol=1e-5)
    assert _rel(res[0], res[1]) <= TOL["float32"]


def test_ctc_loss_is_not_ported():
    """Named when ``CTCLoss`` was missing here; it is ported now: its
    value and its gradient in the prediction, imperative and hybridized,
    against the JAX package's (fp32 throughout: the op's log-softmax and
    recursion are fp32 in both packages)."""
    rng = np.random.RandomState(3)
    pred = rng.randn(2, 10, 6).astype("float32")
    label = np.array([[1, 2, 0, 0], [1, 2, 3, 0]], np.float32)
    res = []
    for pkg, hybridize in ((mt, False), (mt, True), (mx, False)):
        blk = pkg.gluon.loss.CTCLoss()
        if hybridize:
            blk.hybridize()
        with pkg.cpu():
            p = pkg.nd.array(pred)
            p.attach_grad()
            with pkg.autograd.record():
                loss = blk(p, pkg.nd.array(label))
            loss.backward()
            res.append((loss.asnumpy(), p.grad.asnumpy()))
    for val, grad in res[:2]:
        assert val.shape == (2,)
        assert _rel(val, res[2][0]) <= TOL["float32"]
        assert _rel(grad, res[2][1]) <= TOL["float32"]


# the ops the losses use, in nd and through a bound Symbol, with gradients:
# (op, attrs, number of inputs, input kind)
LOSS_OPS = [
    ("log_softmax", dict(axis=-1), 1, "any"),
    ("log_softmax", dict(axis=0), 1, "any"),
    ("softmax", dict(axis=1), 1, "any"),
    ("abs", {}, 1, "any"), ("square", {}, 1, "any"),
    ("log", {}, 1, "positive"), ("exp", {}, 1, "any"),
    ("sigmoid", {}, 1, "any"), ("swapaxes", dict(dim1=0, dim2=1), 1, "any"),
    ("SwapAxis", dict(dim1=1, dim2=0), 1, "any"),
    ("pick", dict(axis=-1, keepdims=True), 2, "index"),
    ("pick", dict(axis=0), 2, "index0"),
    ("where", {}, 3, "cond"),
]


def _op_inputs(kind, n):
    rng = np.random.RandomState(9)
    x = rng.randn(4, 5)
    if kind == "positive":
        x = np.abs(x) + 0.1
    if kind == "index":
        return [x, np.array([1, 0, 4, 2], np.float64)]
    if kind == "index0":
        return [x, np.array([3, 0, 1, 2, 3], np.float64)]
    if kind == "cond":
        return [(rng.rand(4, 5) > 0.5) * 1.0, x, rng.randn(4, 5)]
    return [x]


@pytest.mark.parametrize("symbolic", [False, True])
@pytest.mark.parametrize("op,attrs,n,kind", LOSS_OPS)
def test_loss_ops_match_jax(op, attrs, n, kind, symbolic):
    """``nd.<op>`` (or ``sym.<op>`` bound with ``simple_bind``) in fp64:
    the output and the gradient of its sum in the differentiable inputs."""
    arrays = _op_inputs(kind, n)
    diff = [i for i in range(len(arrays))
            if not (kind in ("index", "index0") and i == 1)
            and not (kind == "cond" and i == 0)]
    res = []
    for pkg in (mt, mx):
        with pkg.cpu():
            if symbolic and pkg is mt:
                names = ["a%d" % i for i in range(len(arrays))]
                out = getattr(pkg.sym, op)(*[pkg.sym.var(nm) for nm in names],
                                           **attrs)
                ex = out.simple_bind(pkg.cpu(), grad_req={
                    nm: ("write" if i in diff else "null")
                    for i, nm in enumerate(names)},
                    type_dict={nm: "float64" for nm in names},
                    **{nm: a.shape for nm, a in zip(names, arrays)})
                y = ex.forward(is_train=True, **{
                    nm: pkg.nd.array(a, dtype="float64")
                    for nm, a in zip(names, arrays)})[0]
                ex.backward(pkg.nd.ones(y.shape, dtype="float64"))
                res.append([y.asnumpy()] + [ex.grad_dict[names[i]].asnumpy()
                                            for i in diff])
                continue
            nds = [pkg.nd.array(a, dtype="float64") for a in arrays]
            for i in diff:
                nds[i].attach_grad()
            with pkg.autograd.record():
                y = getattr(pkg.nd, op)(*nds, **attrs)
                total = y.sum()
            total.backward()
            res.append([y.asnumpy()] + [nds[i].grad.asnumpy() for i in diff])
    for a, b in zip(*res):
        assert a.shape == b.shape
        assert _rel(a, b) <= TOL["float64"]


# -- hybridize: the cached graph ----------------------------------------------
def _mlp(pkg, prefix, act="relu", in_units=0):
    net = pkg.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(16, activation=act, in_units=in_units))
        net.add(pkg.gluon.nn.Dense(4, in_units=16 if in_units else 0))
    return net


def test_hybrid_eager_consistency():
    """The hybridized forward equals the imperative one, and both equal
    the JAX package's from the same seeded init."""
    x = np.random.RandomState(3).randn(3, 7).astype("float32")
    res = {}
    for pkg in (mt, mx):
        with pkg.cpu():
            pkg.random.seed(0)
            with pkg.name.NameManager():
                net = _mlp(pkg, "c_")
            net.initialize()
            eager = net(pkg.nd.array(x)).asnumpy()
            net.hybridize()
            res[pkg.__name__] = eager, net(pkg.nd.array(x)).asnumpy()
    eager, hybrid = res["mxnet_tpu_torch"]
    np.testing.assert_array_equal(eager, hybrid)
    assert _rel(hybrid, res["mxnet_tpu"][1]) <= TOL["float32"]


def test_hybrid_grad_consistency():
    """Gradients through the cached graph equal the imperative ones and
    the JAX package's."""
    rng = np.random.RandomState(4)
    x = rng.randn(4, 5).astype("float32")
    y = rng.randn(4, 2).astype("float32")
    grads = []
    for pkg, hyb in ((mt, False), (mt, True), (mx, True)):
        with pkg.cpu():
            with pkg.name.NameManager():
                net = pkg.gluon.nn.HybridSequential(prefix="g_")
                with net.name_scope():
                    net.add(pkg.gluon.nn.Dense(8, activation="tanh",
                                               in_units=5))
                    net.add(pkg.gluon.nn.Dense(2, in_units=8))
            net.initialize(pkg.init.Constant(0.1))
            if hyb:
                net.hybridize()
            with pkg.autograd.record():
                loss = pkg.gluon.loss.L2Loss()(net(pkg.nd.array(x)),
                                               pkg.nd.array(y))
            loss.backward()
            grads.append({k: p.grad().asnumpy()
                          for k, p in net.collect_params().items()})
    for k in grads[0]:
        np.testing.assert_array_equal(grads[0][k], grads[1][k])
        assert _rel(grads[1][k], grads[2][k]) <= TOL["float32"]


def test_batchnorm_running_stats():
    """Hybridized BatchNorm: a recorded (training) call moves the running
    statistics as the JAX package's does; a call in predict mode uses
    them and leaves them as they are."""
    x = np.random.RandomState(5).randn(4, 3, 5, 5).astype("float32")
    res = []
    for pkg in (mt, mx):
        with pkg.cpu():
            bn = pkg.gluon.nn.BatchNorm(in_channels=3)
            bn.initialize()
            bn.hybridize()
            with pkg.autograd.record():
                bn(pkg.nd.array(x))
            rm = bn.running_mean.data().asnumpy().copy()
            rv = bn.running_var.data().asnumpy().copy()
            assert np.abs(rm).sum() > 0
            out = bn(pkg.nd.array(x)).asnumpy()
            np.testing.assert_array_equal(bn.running_mean.data().asnumpy(),
                                          rm)
            res.append((rm, rv, out))
    for a, b in zip(*res):
        assert _rel(a, b) <= TOL["float32"]


def _conv_pool_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, kernel_size=3, padding=1, activation="relu"))
        net.add(nn.MaxPool2D(2, 2))
        net.add(nn.Conv2D(16, kernel_size=3, padding=1))
        net.add(nn.BatchNorm())
        net.add(nn.Activation("relu"))
        net.add(nn.GlobalAvgPool2D())
        net.add(nn.Flatten())
        net.add(nn.Dense(10))
    return net


@pytest.mark.parametrize("hybridize", [False, True])
def test_conv_pool_net(hybridize):
    x = np.random.RandomState(6).randn(2, 3, 16, 16).astype("float32")
    outs = []
    for pkg in (mt, mx):
        with pkg.cpu():
            pkg.random.seed(1)
            with pkg.name.NameManager():
                net = _conv_pool_net(pkg)
            net.initialize()
            if hybridize:
                net.hybridize()
            outs.append(net(pkg.nd.array(x)).asnumpy())
    assert outs[0].shape == (2, 10)
    assert _rel(outs[0], outs[1]) <= 1e-5


def test_hybridized_block_traces_once_per_signature():
    """One trace per (input shapes and dtypes, training mode); a second
    call of a signature replays; hybridize(), cast() and register_child()
    drop the cache."""
    with mt.cpu():
        net = _mlp(mt, "t_", in_units=5)
        net.initialize()
        net.hybridize()
        port_block.reset_trace_count()
        x = mt.nd.array(np.ones((3, 5), np.float32))
        for _ in range(3):
            net(x)
        assert port_block.trace_count() == 1
        with mt.autograd.record():
            net(x)
            net(x)
        assert port_block.trace_count() == 2  # training mode
        net(mt.nd.array(np.ones((4, 5), np.float32)))
        assert port_block.trace_count() == 3  # another batch size
        net(x)
        assert port_block.trace_count() == 3
        net.hybridize()
        net(x)
        assert port_block.trace_count() == 4
        net.cast("float64")
        net(mt.nd.array(np.ones((3, 5)), dtype="float64"))
        assert port_block.trace_count() == 5
        net.register_child(mt.gluon.nn.Dense(2, in_units=4))
        assert net._cached_op is None


def test_symbol_block_runs_and_trains_the_graph():
    """A SymbolBlock over a network's Symbol and Parameters gives the
    network's output and gradients."""
    x = np.random.RandomState(7).randn(3, 5).astype("float32")
    with mt.cpu():
        net = _mlp(mt, "s_", in_units=5)
        net.initialize()
        out = net(mt.sym.var("data"))
        sb = mt.gluon.SymbolBlock(out, mt.sym.var("data"),
                                  params=net.collect_params())
        grads = []
        for blk in (net, sb):
            with mt.autograd.record():
                y = blk(mt.nd.array(x))
                loss = (y * y).sum()
            loss.backward()
            grads.append((y.asnumpy(), [p.grad().asnumpy().copy() for p in
                                        net.collect_params().values()]))
        np.testing.assert_array_equal(grads[0][0], grads[1][0])
        for a, b in zip(grads[0][1], grads[1][1]):
            np.testing.assert_array_equal(a, b)
        # composed symbolically, it lowers like the network
        composed = sb(mt.sym.var("x"))
        assert composed.list_arguments()[0] == "x"


# -- Trainer ------------------------------------------------------------------
FUSED_CASES = [
    ("sgd", (("learning_rate", 0.1), ("momentum", 0.9))),
    ("adam", (("learning_rate", 0.01),)),
    ("sgd", (("learning_rate", 0.05), ("momentum", 0.9), ("wd", 1e-3),
             ("rescale_grad", 0.5), ("clip_gradient", 0.1))),
    ("adam", (("learning_rate", 0.01), ("wd", 1e-4),
              ("rescale_grad", 2.0))),
    ("rmsprop", (("learning_rate", 0.01),)),
]


def _dense_net(pkg, n_layers=3, width=8):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        for _ in range(n_layers - 1):
            net.add(pkg.gluon.nn.Dense(width, activation="relu"))
        net.add(pkg.gluon.nn.Dense(3))
    return net


def _train(pkg, optimizer, opt_params, dtype="float32", steps=5,
           kvstore="device", hybridize=False, seed=0, batch_size=16):
    """``tests/test_fused_trainer.py::_train``'s regression net: Xavier
    from ``seed``, cast to ``dtype``, ``steps`` Trainer steps on L2Loss.
    Returns ({slot: weight}, {slot: [state arrays]})."""
    with pkg.cpu():
        np.random.seed(seed)
        pkg.random.seed(seed)
        rng = np.random.RandomState(seed + 1)
        with pkg.name.NameManager():
            net = _dense_net(pkg)
        net.initialize(init=pkg.initializer.Xavier())
        net(pkg.nd.array(np.zeros((1, 6), np.float32)))
        if dtype != "float32":
            net.cast(dtype)
        if hybridize:
            net.hybridize()
        trainer = pkg.gluon.Trainer(net.collect_params(), optimizer,
                                    dict(opt_params), kvstore=kvstore)
        loss_fn = pkg.gluon.loss.L2Loss()
        X = rng.randn(steps, batch_size, 6).astype(dtype)
        Y = rng.randn(steps, batch_size, 3).astype(dtype)
        for step in range(steps):
            with pkg.autograd.record():
                loss = loss_fn(net(pkg.nd.array(X[step], dtype=dtype)),
                               pkg.nd.array(Y[step], dtype=dtype))
            loss.backward()
            trainer.step(batch_size)
        params = {i: p.data().asnumpy()
                  for i, p in enumerate(net.collect_params().values())}
        states = {}
        for idx, st in trainer._updater.states.items():
            leaves = []

            def collect(s):
                if s is None:
                    leaves.append(None)
                elif isinstance(s, (tuple, list)):
                    for x in s:
                        collect(x)
                else:
                    leaves.append(s.asnumpy())
            collect(st)
            states[idx] = leaves
        return params, states


def _assert_bitwise(fast, slow):
    assert fast.keys() == slow.keys()
    for k in fast:
        f, s = fast[k], slow[k]
        for a, b in (zip(f, s) if isinstance(f, list) else [(f, s)]):
            if a is None:
                assert b is None
                continue
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("optimizer,opt_params", FUSED_CASES)
def test_fused_matches_loop_bitwise(fused_env, optimizer, opt_params):
    fused_env("1")
    fp, fs = _train(mt, optimizer, opt_params)
    fused_env("0")
    sp, ss = _train(mt, optimizer, opt_params)
    _assert_bitwise(fp, sp)
    _assert_bitwise(fs, ss)


def test_fused_matches_loop_without_kvstore(fused_env):
    case = (("learning_rate", 0.1), ("momentum", 0.9))
    fused_env("1")
    fp, fs = _train(mt, "sgd", case, kvstore=None)
    fused_env("0")
    sp, ss = _train(mt, "sgd", case, kvstore=None)
    _assert_bitwise(fp, sp)
    _assert_bitwise(fs, ss)


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("optimizer,opt_params", FUSED_CASES)
def test_trainer_matches_jax(fused_env, optimizer, opt_params, dtype,
                             hybridize):
    """5 steps of the port's fused Trainer (imperative and hybridized)
    against the JAX package's per-parameter loop, weights and states."""
    fused_env("1")
    pp, ps = _train(mt, optimizer, opt_params, dtype, hybridize=hybridize)
    fused_env("0")
    jp, js = _train(mx, optimizer, opt_params, dtype)
    assert _max_rel(pp.values(), jp.values()) <= TOL[dtype]
    for k in js:
        assert _max_rel([a for a in ps[k] if a is not None],
                        [b for b in js[k] if b is not None]) <= TOL[dtype]


def _one_step_counts(fused_env, value):
    fused_env(value)
    with mt.cpu():
        np.random.seed(0)
        net = _dense_net(mt, n_layers=12)
        net.initialize(init=mt.initializer.Xavier())
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9})
        loss_fn = mt.gluon.loss.L2Loss()
        x = mt.nd.array(np.random.randn(8, 6).astype(np.float32))
        y = mt.nd.array(np.random.randn(8, 3).astype(np.float32))
        counts = []
        for _ in range(2):
            with mt.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            port_fused.reset_update_counts()
            trainer.step(8)
            counts.append((port_fused.fused_update_count(),
                           port_fused.loop_update_count()))
        return len(net.collect_params()), counts


def test_fused_program_call_count(fused_env):
    """A 24-parameter model: one ``fused_update`` a step, no
    per-parameter update."""
    n_params, counts = _one_step_counts(fused_env, "1")
    assert n_params >= 20
    assert counts == [(1, 0), (1, 0)]


def test_loop_program_call_count_is_per_slot(fused_env):
    n_params, counts = _one_step_counts(fused_env, "0")
    assert counts == [(0, n_params), (0, n_params)]


def _stale_grad_case():
    """``tests/test_fused_trainer.py::test_ignore_stale_grad``."""
    with mt.cpu():
        rng = np.random.RandomState(0)
        used = mt.gluon.nn.Dense(4, in_units=6)
        used.initialize()
        unused = mt.gluon.nn.Dense(4, in_units=6)
        unused.initialize()
        unused(mt.nd.array(rng.randn(2, 6).astype(np.float32)))
        params = list(used.collect_params().values()) \
            + list(unused.collect_params().values())
        trainer = mt.gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
        x = mt.nd.array(rng.randn(2, 6).astype(np.float32))
        with mt.autograd.record():
            loss = (used(x) ** 2).sum()
        loss.backward()
        before = {p.name: p.data().asnumpy().copy() for p in params}
        with pytest.raises(UserWarning):
            trainer.step(2)  # the unused branch is stale
        for p in params:  # and nothing was updated
            np.testing.assert_array_equal(p.data().asnumpy(), before[p.name])
        trainer.step(2, ignore_stale_grad=True)
        for p in used.collect_params().values():
            assert np.abs(p.data().asnumpy() - before[p.name]).max() > 0
        for p in unused.collect_params().values():
            np.testing.assert_array_equal(p.data().asnumpy(), before[p.name])
        with pytest.raises(UserWarning):
            trainer.step(2)  # every gradient is stale after a step


def test_ignore_stale_grad(fused_env):
    fused_env("1")
    _stale_grad_case()


def test_stale_grad_loop_path_parity(fused_env):
    fused_env("0")
    _stale_grad_case()


def test_loop_path_honors_hyper_mutation():
    """A hyper-parameter changed between updates takes effect at once."""
    with mt.cpu():
        opt = mt.optimizer.create("sgd", learning_rate=1.0)
        w = mt.nd.array(np.zeros(4, np.float32))
        g = mt.nd.array(np.full(4, 10.0, np.float32))
        opt.update(0, w, g, opt.create_state(0, w))
        np.testing.assert_allclose(w.asnumpy(), -10.0 * np.ones(4))
        opt.clip_gradient = 1.0
        w2 = mt.nd.array(np.zeros(4, np.float32))
        opt.update(1, w2, g, opt.create_state(1, w2))
        np.testing.assert_allclose(w2.asnumpy(), -1.0 * np.ones(4))


def test_trainer_step_converges():
    """``tests/test_gluon.py``'s linear regression: converges, and the
    port's weights after 100 steps are the JAX package's."""
    np.random.seed(0)
    w_true = np.array([[2.0, -3.4]], dtype=np.float32)
    X = np.random.randn(200, 2).astype(np.float32)
    Y = X.dot(w_true.T) + 4.2
    res = []
    for pkg in (mt, mx):
        with pkg.cpu():
            pkg.random.seed(0)
            net = pkg.gluon.nn.Dense(1)
            net.initialize()
            trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": 0.1})
            loss_fn = pkg.gluon.loss.L2Loss()
            for _ in range(100):
                with pkg.autograd.record():
                    loss = loss_fn(net(pkg.nd.array(X)), pkg.nd.array(Y))
                loss.backward()
                trainer.step(X.shape[0])
            res.append((net.weight.data().asnumpy(),
                        net.bias.data().asnumpy()))
    np.testing.assert_allclose(res[0][0], w_true, atol=1e-1)
    np.testing.assert_allclose(res[0][1], [4.2], atol=1e-1)
    assert _max_rel(res[0], res[1]) <= TOL["float32"]


def test_learning_rate_and_scheduler_through_trainer(fused_env):
    """``Trainer.learning_rate``/``set_learning_rate``, and a scheduler
    stepping with the update counts, as in the JAX package."""
    res = []
    fused_env("1")
    for pkg in (mt, mx):
        with pkg.cpu():
            pkg.random.seed(0)
            with pkg.name.NameManager():
                net = _dense_net(pkg)
            net.initialize(init=pkg.initializer.Xavier())
            sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
            trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", {
                "learning_rate": 0.2, "lr_scheduler": sched})
            rng = np.random.RandomState(3)
            lrs = []
            for _ in range(5):
                x = pkg.nd.array(rng.randn(4, 6).astype(np.float32))
                with pkg.autograd.record():
                    loss = (net(x) ** 2).sum()
                loss.backward()
                trainer.step(4)
                lrs.append(trainer._optimizer._get_lr(0))
            res.append((lrs, [p.data().asnumpy() for p in
                              net.collect_params().values()]))
    assert res[0][0] == res[1][0]
    assert _max_rel(res[0][1], res[1][1]) <= TOL["float32"]
    with mt.cpu():
        net = mt.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.3})
        assert trainer.learning_rate == 0.3
        trainer.set_learning_rate(0.1)
        assert trainer.learning_rate == 0.1


def test_trainer_refusals(monkeypatch):
    """What the JAX package refuses, this package refuses: the kvstore is
    made at the first step, where ``"nccl"`` raises as the reference's
    ``create`` does, and ``"dist_sync"`` under a launcher (``DMLC_ROLE``)
    raises naming A.10 (the distributed store).  A Dense initialized on
    ``[cpu(0), cpu(1)]`` steps and matches the reference."""
    def stepped(pkg, kvstore, ctx=None):
        with pkg.cpu():
            net = pkg.gluon.nn.Dense(2, in_units=3)
            net.initialize(pkg.init.Constant(0.5), ctx=ctx)
            trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": 0.1},
                                        kvstore=kvstore)
            with pkg.autograd.record():
                x = np.arange(6, dtype=np.float32).reshape(2, 3)
                loss = net(pkg.nd.array(x)).sum()
            loss.backward()
            trainer.step(2)
            return [p.data().asnumpy()
                    for p in net.collect_params().values()]

    for pkg in (mt, mx):
        with pytest.raises(pkg.base.MXNetError, match="unknown kvstore"):
            stepped(pkg, "nccl")
    monkeypatch.setenv("DMLC_ROLE", "worker")
    with pytest.raises(MXNetError, match="A.10"):
        stepped(mt, "dist_sync")
    monkeypatch.delenv("DMLC_ROLE")
    got = stepped(mt, "device", [mt.cpu(0), mt.cpu(1)])
    want = stepped(mx, "device", [mx.cpu(0), mx.cpu(1)])
    assert _max_rel(got, want) <= TOL["float32"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_gluon_entry_points_without_device_raise(no_cuda):
    """Without a context the Gluon entry points take gpu(0), and with no
    card they raise; nothing moves to the CPU on its own."""
    net = mt.gluon.nn.Dense(2, in_units=3)
    with pytest.raises(MXNetError):
        net.initialize()
    with pytest.raises(MXNetError):
        mt.gluon.utils.split_and_load(np.ones((2, 3)), [mt.Context("gpu")])
    with mt.cpu():
        net = _mlp(mt, "d_", in_units=5)
        net.initialize()
        net.hybridize()
        x = mt.nd.array(np.ones((2, 5), np.float32))
        assert net(x).context == mt.cpu()


# -- utils --------------------------------------------------------------------
def test_split_and_load():
    """``split_data`` and ``clip_global_norm`` as in ``tests/test_gluon.py``
    and against the JAX package; ``split_and_load`` over one context and
    over two."""
    x = np.random.RandomState(8).randn(8, 3).astype("float32")
    res = []
    for pkg in (mt, mx):
        with pkg.cpu():
            slices = pkg.gluon.utils.split_data(pkg.nd.array(x), 4)
            uneven = pkg.gluon.utils.split_data(pkg.nd.array(x), 3,
                                                even_split=False)
            arrs = [pkg.nd.ones((2, 2)) * 10 for _ in range(2)]
            norm = pkg.gluon.utils.clip_global_norm(arrs, 1.0)
            loaded = pkg.gluon.utils.split_and_load(x, [pkg.cpu()])
            res.append(([s.asnumpy() for s in slices],
                        [s.asnumpy() for s in uneven],
                        norm, [a.asnumpy() for a in arrs],
                        [a.asnumpy() for a in loaded]))
    port, ref = res
    assert len(port[0]) == 4 and port[0][0].shape == (2, 3)
    assert [s.shape for s in port[1]] == [(2, 3), (2, 3), (4, 3)]
    assert port[2] > 1.0
    total = sum((a ** 2).sum() for a in port[3])
    np.testing.assert_allclose(np.sqrt(total), 1.0, rtol=1e-4)
    for a, b in zip(port[0] + port[1] + port[4], ref[0] + ref[1] + ref[4]):
        np.testing.assert_array_equal(a, b)
    assert _rel(port[2], ref[2]) <= TOL["float32"]
    assert _max_rel(port[3], ref[3]) <= TOL["float32"]
    port, ref = [pkg.gluon.utils.split_and_load(x, [pkg.cpu(0), pkg.cpu(1)])
                 for pkg in (mt, mx)]
    assert [str(a.context) for a in port] == [str(b.context) for b in ref] \
        == ["cpu(0)", "cpu(1)"]
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_clip_global_norm_leaves_nonfinite_and_small_unscaled():
    with mt.cpu():
        small = [mt.nd.ones((2,)) * 0.1]
        assert abs(mt.gluon.utils.clip_global_norm(small, 1.0)
                   - np.sqrt(0.02)) < 1e-6
        np.testing.assert_array_equal(small[0].asnumpy(),
                                      np.full(2, 0.1, np.float32))
        bad = [mt.nd.array(np.array([np.inf, 3.0], np.float32)),
               mt.nd.ones((2,)) * 10]
        norm = mt.gluon.utils.clip_global_norm(bad, 1.0)
        assert not np.isfinite(norm)
        np.testing.assert_array_equal(bad[1].asnumpy(), [10.0, 10.0])


# -- the thumbnail ResNet-18 -------------------------------------------------
@pytest.fixture(scope="module")
def thumbnail18():
    """``tests/test_torch_gluon_resnet.py``'s ``thumbnail18``:
    resnet18_v1(thumbnail=True, classes=10) at batch 2 x 3 x 32 x 32,
    Xavier in the JAX package after ``random.seed(3)``, and its seeded
    batch; the parameters and moving statistics by name, as numpy."""
    shape = (2, 3, 32, 32)
    _, arg, aux = gluon_resnet_tests._jax_params(
        "resnet18_v1", dict(thumbnail=True, classes=THUMB_CLASSES), shape)
    rng = np.random.RandomState(11)
    x = rng.rand(*shape).astype(np.float32)
    y = rng.randint(0, THUMB_CLASSES, (2,)).astype(np.float32)
    return dict(params=dict(arg, **aux), x=x, y=y, shape=shape)


def _thumb_gluon(pkg, dtype, t, steps):
    """``steps`` hybridized Gluon steps (SGD lr 0.1, momentum 0.9, wd
    1e-4) from the fixture ``t``; returns (each step's logits, the
    parameters after)."""
    with pkg.cpu():
        with pkg.name.NameManager():
            net = pkg.gluon.model_zoo.vision.get_model(
                "resnet18_v1", thumbnail=True, classes=THUMB_CLASSES)
        if dtype != "float32":
            net.cast(dtype)
        net.initialize()
        for n, p in net.collect_params().items():
            p.set_data(pkg.nd.array(t["params"][n].astype(dtype),
                                    dtype=dtype))
        net.hybridize()
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        x = pkg.nd.array(t["x"], dtype=dtype)
        y = pkg.nd.array(t["y"], dtype=dtype)
        outs = []
        for _ in range(steps):
            with pkg.autograd.record():
                out = net(x)
                loss = loss_fn(out, y)
            loss.backward()
            trainer.step(t["shape"][0])
            outs.append(out.asnumpy())
        return outs, {n: p.data().asnumpy()
                      for n, p in net.collect_params().items()}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_thumbnail_resnet18_gluon_steps_match_jax(thumbnail18, dtype):
    """3 hybridized Trainer steps in both packages from one init: fp64
    outputs and parameters to 1e-6, fp32 step-1 outputs to 1e-4."""
    pouts, pparams = _thumb_gluon(mt, dtype, thumbnail18, 3)
    jouts, jparams = _thumb_gluon(mx, dtype, thumbnail18, 3)
    assert _rel(pouts[0], jouts[0]) <= 1e-4
    if dtype == "float64":
        assert _max_rel(pouts, jouts) <= 1e-6
        assert max(_rel(pparams[n], jparams[n]) for n in jparams) <= 1e-6


def test_thumbnail_resnet18_gluon_step_matches_module(thumbnail18):
    """One Gluon step against one step of the port's Module (the same net
    lowered with SoftmaxOutput, ``_fit_step``) in fp64."""
    t = thumbnail18
    outs, gparams = _thumb_gluon(mt, "float64", t, 1)
    with mt.cpu():
        with mt.name.NameManager():
            net = mt.gluon.model_zoo.vision.get_model(
                "resnet18_v1", thumbnail=True, classes=THUMB_CLASSES)
        net.cast("float64")
        s = mt.sym.SoftmaxOutput(net(mt.sym.var("data")),
                                 mt.sym.var("softmax_label"), name="softmax")
        mod = mt.mod.Module(s, context=mt.cpu())
        mod.bind(data_shapes=[mt.io.DataDesc("data", t["shape"],
                                             dtype="float64")],
                 label_shapes=[mt.io.DataDesc("softmax_label",
                                              t["shape"][:1],
                                              dtype="float64")])
        arg_names = set(s.list_arguments())
        mod.set_params(
            {n: mt.nd.array(v, dtype="float64")
             for n, v in t["params"].items() if n in arg_names},
            {n: mt.nd.array(v, dtype="float64")
             for n, v in t["params"].items() if n not in arg_names})
        mod.init_optimizer(optimizer="sgd", optimizer_params=(
            ("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4)))
        mod._fit_step(mt.io.DataBatch(
            [mt.nd.array(t["x"], dtype="float64")],
            [mt.nd.array(t["y"], dtype="float64")]))
        probs = mod.get_outputs()[0].asnumpy()
        arg, aux = mod.get_params()
    logits = outs[0]
    soft = np.exp(logits - logits.max(1, keepdims=True))
    soft /= soft.sum(1, keepdims=True)
    assert _rel(soft, probs) <= 1e-12
    for n, v in list(arg.items()) + list(aux.items()):
        assert _rel(gparams[n], v.asnumpy()) <= 1e-10, n
