"""Optimizers, update ops and LR schedulers of the PyTorch package against
the JAX package on the CPU.

The cases of ``tests/test_optimizer.py`` run in both packages on the same
numpy inputs, and each optimizer's ``update`` over 3 steps (with wd,
``rescale_grad`` and ``clip_gradient``) is held to the JAX package's:
1e-12 relative to max(1, |v|) in fp64, 1e-6 in fp32.  Both packages do
the same operations in the same order on the same dtypes (Adam's,
Adamax's and Nadam's fp32 bias corrections included), so the fp64 runs
agree to a few ulps and the fp32 runs to the rounding of a reordered
product.  ``SGLD`` draws its noise from the device's ``torch.Generator``
(``random.generator``), whose stream is not JAX's, so it is held to a
numpy reference built from its own draws instead.  Inside the port,
every optimizer's ``fused_update`` (multi-tensor ops over a list of
parameters) equals its per-parameter ``update`` bit for bit.
"""
import math

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.optimizer import _state_raw

NAMES = ["sgd", "nag", "adam", "adagrad", "rmsprop", "adadelta", "ftrl",
         "adamax", "nadam", "sgld", "dcasgd", "signum"]
# the hyper-parameters that give each rule its state (momentum, centered)
RULE_KW = {"sgd": dict(momentum=0.9), "nag": dict(momentum=0.9),
           "dcasgd": dict(momentum=0.9), "rmsprop": dict(centered=True),
           "signum": dict(momentum=0.9)}
COMMON = dict(wd=0.01, rescale_grad=0.5, clip_gradient=2.0)
TOL = {"float64": 1e-12, "float32": 1e-6}


@pytest.fixture(scope="module", autouse=True)
def x64():
    """fp64 in the JAX package needs x64, which another test in this
    worker may have turned off."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)
                        / np.maximum(1.0, np.abs(b))))


def _jax_steps(opt, w0, grads, dtype):
    w = mx.nd.array(w0, dtype=dtype)
    state = opt.create_state(0, w)
    for g in grads:
        opt.update(0, w, mx.nd.array(g, dtype=dtype), state)
    return w.asnumpy()


def _port_steps(opt, w0, grads, dtype):
    with mt.cpu():
        w = mt.nd.array(w0, dtype=dtype)
        state = opt.create_state(0, w)
        for g in grads:
            opt.update(0, w, mt.nd.array(g, dtype=dtype), state)
        return w.asnumpy()


def _run_both(w0, grads, n=None, make=None):
    """The same steps in both packages; ``make(pkg)`` builds the
    optimizer."""
    dtype = w0.dtype
    return (_port_steps(make(mt), w0, grads[:n], dtype),
            _jax_steps(make(mx), w0, grads[:n], dtype))


# -- the cases of tests/test_optimizer.py, in both packages -----------------
def _inputs(seed, shape, n=4):
    rng = np.random.RandomState(seed)
    w0 = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return w0, [g] * n


def test_sgd_matches_numpy():
    w0, grads = _inputs(0, (4, 3))
    got, ref_jax = _run_both(w0, grads, 3, lambda pkg: pkg.optimizer.SGD(
        learning_rate=0.1, rescale_grad=1.0, wd=0.0))
    np.testing.assert_allclose(got, w0 - 3 * 0.1 * grads[0], rtol=1e-5)
    assert _rel(got, ref_jax) <= TOL["float32"]


def test_sgd_momentum_matches_numpy():
    w0, grads = _inputs(1, (5,))
    lr, mom = 0.1, 0.9
    got, ref_jax = _run_both(w0, grads, 3, lambda pkg: pkg.optimizer.SGD(
        learning_rate=lr, momentum=mom, rescale_grad=1.0, wd=0.0))
    w, m = w0.copy(), np.zeros_like(w0)
    for _ in range(3):
        m = mom * m - lr * grads[0]
        w = w + m
    np.testing.assert_allclose(got, w, rtol=1e-5)
    assert _rel(got, ref_jax) <= TOL["float32"]


def test_sgd_wd_matches_numpy():
    w0, _ = _inputs(2, (5,))
    grads = [np.zeros(5, np.float32)]
    got, ref_jax = _run_both(w0, grads, 1, lambda pkg: pkg.optimizer.SGD(
        learning_rate=0.1, rescale_grad=1.0, wd=0.01))
    np.testing.assert_allclose(got, w0 * (1 - 0.1 * 0.01), rtol=1e-5)
    assert _rel(got, ref_jax) <= TOL["float32"]


def test_adam_matches_numpy():
    w0, grads = _inputs(3, (6,))
    lr, b1, b2, eps = 0.01, 0.9, 0.999, 1e-8
    got, ref_jax = _run_both(w0, grads, 4, lambda pkg: pkg.optimizer.Adam(
        learning_rate=lr, beta1=b1, beta2=b2, epsilon=eps, rescale_grad=1.0,
        wd=0.0))
    g = grads[0]
    w = w0.astype(np.float64)
    m, v = np.zeros_like(w), np.zeros_like(w)
    for t in range(1, 5):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        w = w - lr * np.sqrt(1 - b2 ** t) / (1 - b1 ** t) * m / (
            np.sqrt(v) + eps)
    np.testing.assert_allclose(got, w.astype(np.float32), rtol=1e-4)
    assert _rel(got, ref_jax) <= TOL["float32"]


def test_rmsprop_runs_and_converges_direction():
    w0 = np.ones(4, np.float32)
    grads = [np.ones(4, np.float32)] * 5
    got, ref_jax = _run_both(w0, grads, 5, lambda pkg: pkg.optimizer.RMSProp(
        learning_rate=0.1, rescale_grad=1.0, wd=0.0))
    assert (got < w0).all()
    assert _rel(got, ref_jax) <= TOL["float32"]


@pytest.mark.parametrize("name", NAMES)
def test_all_optimizers_step_finite(name):
    """Every registered optimizer at its defaults, 3 steps: finite, and
    (but for SGLD's noise) the JAX package's weights."""
    rng = np.random.RandomState(4)
    w0 = rng.randn(8).astype(np.float32)
    grads = [rng.randn(8).astype(np.float32)] * 3
    mt.random.seed(0)
    got, ref_jax = _run_both(w0, grads, 3,
                             lambda pkg: pkg.optimizer.create(name))
    assert np.isfinite(got).all()
    if name != "sgld":
        assert _rel(got, ref_jax) <= TOL["float32"]


def test_lr_scheduler_factor():
    lrs = []
    for pkg in (mt, mx):
        sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        sched.base_lr = 1.0
        lrs.append([sched(i) for i in [1, 2, 3, 4, 5]])
    assert lrs[0] == lrs[1]
    assert lrs[0][0] == 1.0 and lrs[0][-1] <= 0.25 + 1e-6


def test_multifactor_scheduler():
    got = []
    for pkg in (mt, mx):
        sched = pkg.lr_scheduler.MultiFactorScheduler(step=[2, 4],
                                                      factor=0.1)
        sched.base_lr = 1.0
        got.append(sched(5))
    assert got[0] == got[1]
    assert abs(got[0] - 0.01) < 1e-9


def test_updater_states_roundtrip():
    """States pickled by ``get_states`` and restored by ``set_states``
    continue the trajectory: the port's two updates equal the JAX
    package's."""
    rng = np.random.RandomState(6)
    w0 = rng.randn(4).astype(np.float32)
    g0 = rng.randn(4).astype(np.float32)
    res = []
    for pkg in (mt, mx):
        with pkg.cpu():
            opt = pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9)
            upd = pkg.optimizer.get_updater(opt)
            w = pkg.nd.array(w0)
            g = pkg.nd.array(g0)
            upd(0, g, w)
            blob = upd.get_states()
            upd2 = pkg.optimizer.get_updater(pkg.optimizer.SGD(
                learning_rate=0.1, momentum=0.9))
            upd2.set_states(blob)
            upd2(0, g, w)
            res.append(w.asnumpy())
    assert np.isfinite(res[0]).all()
    assert _rel(res[0], res[1]) <= TOL["float32"]


def test_lr_wd_mult():
    res = []
    for pkg in (mt, mx):
        with pkg.cpu():
            opt = pkg.optimizer.SGD(learning_rate=1.0, rescale_grad=1.0,
                                    wd=0.0, param_idx2name={0: "a", 1: "b"})
            opt.set_lr_mult({"a": 0.0})
            w = pkg.nd.array(np.ones(3, np.float32))
            g = pkg.nd.array(np.ones(3, np.float32))
            opt.update(0, w, g, opt.create_state(0, w))
            res.append(w.asnumpy())
    np.testing.assert_allclose(res[0], np.ones(3))  # lr_mult 0: no change
    np.testing.assert_array_equal(res[0], res[1])


# -- each rule against the JAX package, fp64 and fp32 -----------------------
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", [n for n in NAMES if n != "sgld"])
def test_update_matches_jax(name, dtype):
    """3 updates with wd, rescale_grad and clip_gradient (and momentum or
    centering where the rule has them)."""
    rng = np.random.RandomState(7)
    w0 = rng.randn(5, 4).astype(dtype)
    grads = [3 * rng.randn(5, 4).astype(dtype) for _ in range(3)]
    kw = dict(COMMON, **RULE_KW.get(name, {}))
    got, ref_jax = _run_both(w0, grads, 3,
                             lambda pkg: pkg.optimizer.create(name, **kw))
    assert _rel(got, ref_jax) <= TOL[dtype], _rel(got, ref_jax)


def test_sgld_matches_its_own_noise():
    """SGLD: w - lr/2 (g + wd w) + sqrt(lr) N(0, 1), the noise drawn from
    the weight's device generator in the order of the updates."""
    rng = np.random.RandomState(8)
    w0 = rng.randn(6).astype(np.float64)
    g0 = rng.randn(6).astype(np.float64)
    lr, wd = 0.1, 0.01
    mt.random.seed(5)
    got = _port_steps(mt.optimizer.SGLD(learning_rate=lr, wd=wd), w0,
                      [g0] * 2, "float64")
    mt.random.seed(5)
    gen = mt.random.generator(mt.cpu())
    w = torch.from_numpy(w0.copy())
    g = torch.from_numpy(g0)
    for _ in range(2):
        noise = torch.randn(w.shape, generator=gen, dtype=w.dtype)
        w = w - lr / 2 * (g + wd * w) + math.sqrt(lr) * noise
    np.testing.assert_allclose(got, w.numpy(), rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("name", NAMES)
def test_fused_update_equals_update_bitwise(name):
    """``fused_update`` over three parameters of two shapes equals three
    ``update`` calls, weights and states, bit for bit, over 3 steps."""
    kw = dict(COMMON, **RULE_KW.get(name, {}))
    rng = np.random.RandomState(9)
    shapes = [(5, 4), (7,), (5, 4)]
    w0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [[3 * rng.randn(*s).astype(np.float32) for s in shapes]
          for _ in range(3)]
    runs = []
    for fused in (False, True):
        mt.random.seed(0)
        with mt.cpu():
            opt = mt.optimizer.create(name, **kw)
            ws = [mt.nd.array(w) for w in w0]
            states = [opt.create_state(i, w) for i, w in enumerate(ws)]
            for step in gs:
                grads = [mt.nd.array(g) for g in step]
                if fused:
                    for i in range(len(ws)):
                        opt._update_count(i)
                    opt.fused_update(
                        [w._data for w in ws], [g._data for g in grads],
                        [_state_raw(s) for s in states],
                        [opt._get_lr(i) for i in range(len(ws))],
                        [opt._get_wd(i) for i in range(len(ws))],
                        [opt._index_update_count[i] for i in range(len(ws))])
                else:
                    for i, (w, g) in enumerate(zip(ws, grads)):
                        opt.update(i, w, g, states[i])
            flat = [w.asnumpy() for w in ws]
            for s in states:
                raw = _state_raw(s)
                raw = raw if isinstance(raw, tuple) else (raw,)
                flat += [r.numpy().copy() for r in raw if r is not None]
            runs.append(flat)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_multi_precision_sgd_matches_jax(momentum):
    """fp16 weights with an fp32 master copy (``mp_sgd_update`` and
    ``mp_sgd_mom_update``)."""
    rng = np.random.RandomState(10)
    w0 = rng.randn(16).astype(np.float16)
    grads = [rng.randn(16).astype(np.float16) for _ in range(3)]
    got, ref_jax = _run_both(w0, grads, 3, lambda pkg: pkg.optimizer.SGD(
        learning_rate=0.1, momentum=momentum, wd=0.01, multi_precision=True))
    np.testing.assert_array_equal(got, ref_jax)


# -- schedulers and the Optimizer's hooks -----------------------------------
def _schedulers(pkg):
    ls = pkg.lr_scheduler
    return {"factor": ls.FactorScheduler(step=3, factor=0.5,
                                         stop_factor_lr=0.02),
            "multifactor": ls.MultiFactorScheduler(step=[2, 5, 7],
                                                   factor=0.3),
            "poly": ls.PolyScheduler(max_update=8, base_lr=0.4, pwr=2,
                                     final_lr=0.01),
            "cosine": ls.CosineScheduler(max_update=8, base_lr=0.4,
                                         final_lr=0.01)}


@pytest.mark.parametrize("kind", ["factor", "multifactor", "poly", "cosine"])
def test_schedulers_match_jax(kind):
    got = []
    for pkg in (mt, mx):
        sched = _schedulers(pkg)[kind]
        sched.base_lr = 0.4
        got.append([sched(i) for i in range(0, 12)])
    assert got[0] == got[1]


@pytest.mark.parametrize("kind", ["factor", "multifactor", "poly", "cosine"])
def test_optimizer_with_scheduler_matches_jax(kind):
    """``lr_scheduler=`` sets the scheduler's base_lr to learning_rate and
    each update takes the rate at its update count."""
    rng = np.random.RandomState(11)
    w0 = rng.randn(6).astype(np.float64)
    grads = [rng.randn(6).astype(np.float64) for _ in range(10)]
    got, ref_jax = _run_both(w0, grads, 10, lambda pkg: pkg.optimizer.SGD(
        learning_rate=0.3, momentum=0.9,
        lr_scheduler=_schedulers(pkg)[kind]))
    assert _rel(got, ref_jax) <= TOL["float64"]


def test_learning_rate_and_set_learning_rate():
    opt = mt.optimizer.SGD(learning_rate=0.2)
    assert opt.learning_rate == 0.2
    opt.set_learning_rate(0.05)
    assert opt.learning_rate == opt.lr == 0.05
    sched = mt.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    opt = mt.optimizer.SGD(learning_rate=1.0, lr_scheduler=sched)
    assert sched.base_lr == 1.0
    opt.num_update = 3
    assert opt.learning_rate == 0.25
    with pytest.raises(UserWarning):
        opt.set_learning_rate(0.1)


def test_supports_fused_and_registry():
    for name in NAMES:
        assert mt.optimizer.create(name).supports_fused(), name
    assert not mt.optimizer.create("test").supports_fused()
    assert isinstance(mt.optimizer.create("ccsgd"), mt.optimizer.SGD)
    with pytest.raises(MXNetError):
        mt.optimizer.create("no_such_optimizer")


def test_test_optimizer_matches_jax():
    rng = np.random.RandomState(12)
    w0 = rng.randn(5).astype(np.float32)
    grads = [rng.randn(5).astype(np.float32)] * 2
    got, ref_jax = _run_both(w0, grads, 2, lambda pkg: pkg.optimizer.create(
        "test", rescale_grad=0.5))
    np.testing.assert_array_equal(got, ref_jax)


# -- the update ops, as nd ops ----------------------------------------------
OPS = [  # (op, state inputs, attrs)
    ("sgd_update", 0, dict(lr=0.1, wd=0.01)),
    ("sgd_mom_update", 1, dict(lr=0.1, momentum=0.9, wd=0.01)),
    ("adam_update", 2, dict(lr=0.01, wd=0.01, clip_gradient=1.0)),
    ("rmsprop_update", 1, dict(lr=0.01, clip_weights=0.5)),
    ("rmspropalex_update", 3, dict(lr=0.01, wd=0.01)),
    ("ftrl_update", 2, dict(lr=0.1, lamda1=0.05)),
    ("signsgd_update", 0, dict(lr=0.1, wd=0.01)),
    ("signum_update", 1, dict(lr=0.1, momentum=0.9, rescale_grad=0.5)),
]


@pytest.mark.parametrize("op,n_state,attrs", OPS)
def test_update_ops_match_jax(op, n_state, attrs):
    """``nd.<op>`` on NDArrays: the new weight, and the state written back
    into the state inputs, in fp64."""
    rng = np.random.RandomState(13)
    # states a rule can reach: the first (a mean square) above the square
    # of the others (rmspropalex takes the root of n - g^2)
    arrays = [rng.randn(4, 3) for _ in range(2)] + \
        [(0.5 if i == 0 else 0.1) * rng.rand(4, 3) + (0.1 if i == 0 else 0)
         for i in range(n_state)]
    res = []
    for pkg in (mt, mx):
        with pkg.cpu():
            nds = [pkg.nd.array(a, dtype="float64") for a in arrays]
            out = getattr(pkg.nd, op)(*nds, **attrs)
            res.append([out.asnumpy()] + [s.asnumpy() for s in nds[2:]])
    for a, b in zip(*res):
        assert np.isfinite(a).all()
        assert _rel(a, b) <= TOL["float64"]


def test_mp_update_ops_match_jax():
    rng = np.random.RandomState(14)
    w = rng.randn(8).astype(np.float16)
    g = rng.randn(8).astype(np.float16)
    mom = rng.randn(8).astype(np.float32)
    res = []
    for pkg in (mt, mx):
        with pkg.cpu():
            w32 = pkg.nd.array(w.astype(np.float32))
            m = pkg.nd.array(mom)
            out = pkg.nd.mp_sgd_mom_update(
                pkg.nd.array(w, dtype="float16"),
                pkg.nd.array(g, dtype="float16"), m, w32, lr=0.1,
                momentum=0.9, wd=0.01)
            out2 = pkg.nd.mp_sgd_update(pkg.nd.array(w, dtype="float16"),
                                        pkg.nd.array(g, dtype="float16"),
                                        w32, lr=0.1)
            res.append([out.asnumpy(), out2.asnumpy(), m.asnumpy(),
                        w32.asnumpy()])
    for a, b in zip(*res):
        np.testing.assert_array_equal(a, b)
