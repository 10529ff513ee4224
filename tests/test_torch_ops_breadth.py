"""The op breadth of the PyTorch package against the JAX package on the
CPU: the same seeded numpy inputs through ``mxnet_tpu`` and
``mxnet_tpu_torch``.

Part 1 mirrors the JAX package's own operator tests case for case
(``tests/test_operator.py``, ``test_operator_indexing.py`` but the
bilinear sampler, ``test_operator_extended.py`` but ROI pooling,
correlation, the grid/spatial ops, linalg, fft, quantization and count
sketch, and ``test_operator_zoo.py``'s deconvolution shape, low-precision
and numeric-gradient cases): each keeps the reference's own oracle
(numpy, finite differences) with its tolerance, and also holds the port's
result against the JAX package's.

Part 2 is the op sweep of ``mxnet_tpu_torch.test_utils.op_cases`` for the
elemwise and reduce ops (``test_torch_ops_matrix_nn.py`` has the rest):
forward and gradients under a seeded head gradient, each case at the
tolerance stated beside it there (``FP32_TOL`` 1e-5 relative by default;
``BF16_TOL`` 2^-6 relative for the bf16 reruns of the unary and reduce
ops).

Parity tolerances of part 1: fp32 results of the same formula, rtol 1e-5
and atol 1e-6 (other summation orders); gradients, rtol 1e-5 and atol
1e-5.
"""
import jax
import numpy as np
import pytest
import scipy.special as sp
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.registry import OP_REGISTRY
from mxnet_tpu_torch.test_utils import op_cases, run_op_case, BF16_TOL

PARITY = dict(rtol=1e-5, atol=1e-6)
GRAD_PARITY = dict(rtol=1e-5, atol=1e-5)
SWEEP_MODULES = ("elemwise", "reduce")


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


@pytest.fixture(autouse=True)
def own_names():
    """Symbols and blocks made here take their names from name managers
    of their own: the processes' global counters, which a later test may
    read (auto-named nodes of a traced net), stay as they were."""
    with mx.name.NameManager(), mt.name.NameManager():
        yield


def both(fn):
    """``fn(pkg)`` in the JAX package and in this one, each on its CPU:
    (theirs, ours) as numpy (lists and tuples element by element)."""
    def host(v):
        if isinstance(v, (list, tuple)):
            return [host(x) for x in v]
        return v.astype("float64").asnumpy() if hasattr(v, "asnumpy") \
            else np.asarray(v)
    out = []
    for pkg in (mx, mt):
        with pkg.cpu():
            out.append(host(fn(pkg)))
    return out


def close(a, b, **tol):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            close(x, y, **tol)
        return
    np.testing.assert_allclose(a, b, **(tol or PARITY))


def grads(pkg, fn, arrays, dtype="float32"):
    """``fn(*nds)`` and the gradients of sum(output) in ``pkg``."""
    nds = [pkg.nd.array(a, dtype=dtype) for a in arrays]
    for x in nds:
        x.attach_grad()
    with pkg.autograd.record():
        out = fn(pkg, *nds)
    out.backward()
    return [out] + [x.grad for x in nds]


def fd_grads(fn, arrays, eps=1e-6):
    """Central differences of sum(fn(pkg, *nds)) in this package, fp64."""
    out = []
    for i, a in enumerate(arrays):
        a = np.asarray(a, np.float64)
        g = np.zeros_like(a)
        for j in range(a.size):
            vals = []
            for sign in (1, -1):
                b = a.copy().reshape(-1)
                b[j] += sign * eps
                args = [np.asarray(x, np.float64) for x in arrays]
                args[i] = b.reshape(a.shape)
                with mt.cpu():
                    nds = [mt.nd.array(x, dtype="float64") for x in args]
                    vals.append(float(fn(mt, *nds).sum().asscalar()))
            g.reshape(-1)[j] = (vals[0] - vals[1]) / (2 * eps)
        out.append(g)
    return out


def check_grads(fn, arrays, fd=True, fd_tol=1e-4):
    """The port's forward and gradients against the JAX package's (fp32),
    and, with ``fd``, the port's fp64 gradients against finite
    differences (the reference's numeric-gradient oracle)."""
    theirs, ours = both(lambda pkg: grads(pkg, fn, arrays))
    close(ours[0], theirs[0])
    close(ours[1:], theirs[1:], **GRAD_PARITY)
    if fd:
        with mt.cpu():
            got = grads(mt, fn, [np.asarray(a, np.float64) for a in arrays],
                        dtype="float64")
        for g, want in zip(got[1:], fd_grads(fn, arrays)):
            np.testing.assert_allclose(g.asnumpy(), want, rtol=fd_tol,
                                       atol=fd_tol)


# ---- tests/test_operator.py ----------------------------------------------
UNARY_CASES = [
    ("relu", lambda x: np.maximum(x, 0), (-2, 2)),
    ("sigmoid", lambda x: 1 / (1 + np.exp(-x)), (-4, 4)),
    ("tanh", np.tanh, (-2, 2)),
    ("exp", np.exp, (-2, 2)),
    ("log", np.log, (0.1, 4)),
    ("sqrt", np.sqrt, (0.1, 4)),
    ("square", np.square, (-2, 2)),
    ("abs", np.abs, (0.3, 2)),
    ("sin", np.sin, (-3, 3)),
    ("cos", np.cos, (-3, 3)),
    ("arctan", np.arctan, (-2, 2)),
    ("cbrt", np.cbrt, (0.1, 4)),
    ("log1p", np.log1p, (-0.5, 3)),
    ("expm1", np.expm1, (-2, 2)),
    ("rsqrt", lambda x: 1 / np.sqrt(x), (0.5, 4)),
    ("reciprocal", lambda x: 1 / x, (0.5, 4)),
]


@pytest.mark.parametrize("name,ref,rng", UNARY_CASES,
                         ids=[c[0] for c in UNARY_CASES])
def test_unary_forward_and_grad(name, ref, rng):
    x = np.random.RandomState(0).uniform(rng[0], rng[1], (3, 4)).astype(
        np.float32)
    theirs, ours = both(lambda pkg: getattr(pkg.nd, name)(pkg.nd.array(x)))
    np.testing.assert_allclose(ours, ref(x).astype(np.float32), rtol=1e-4,
                               atol=1e-5)
    close(ours, theirs)
    check_grads(lambda pkg, a: getattr(pkg.nd, name)(a), [x])


BIN_CASES = ["broadcast_add", "broadcast_sub", "broadcast_mul",
             "broadcast_div", "broadcast_maximum", "broadcast_minimum",
             "broadcast_power"]
BIN_REF = [np.add, np.subtract, np.multiply, np.divide, np.maximum,
           np.minimum, np.power]


@pytest.mark.parametrize("name,ref", zip(BIN_CASES, BIN_REF), ids=BIN_CASES)
def test_binary_broadcast(name, ref):
    rng = np.random.RandomState(1)
    a = rng.uniform(0.5, 2, (2, 1, 4)).astype(np.float32)
    b = rng.uniform(0.5, 2, (1, 3, 4)).astype(np.float32)
    theirs, ours = both(lambda pkg: getattr(pkg.nd, name)(
        pkg.nd.array(a), pkg.nd.array(b)))
    np.testing.assert_allclose(ours, ref(a, b), rtol=1e-4, atol=1e-5)
    close(ours, theirs)
    check_grads(lambda pkg, x, y: getattr(pkg.nd, name)(x, y), [a, b])


def test_reductions():
    x = np.random.RandomState(2).uniform(-2, 2, (3, 4, 5)).astype(np.float32)
    for name, ref in [("sum", np.sum), ("mean", np.mean), ("max", np.max),
                      ("min", np.min), ("prod", np.prod)]:
        theirs, ours = both(lambda pkg: [
            getattr(pkg.nd, name)(pkg.nd.array(x)),
            getattr(pkg.nd, name)(pkg.nd.array(x), axis=1)])
        np.testing.assert_allclose(ours[0], ref(x), rtol=1e-3)
        np.testing.assert_allclose(ours[1], ref(x, axis=1), rtol=1e-3)
        close(ours, theirs, rtol=1e-5, atol=1e-5)
    check_grads(lambda pkg, a: pkg.nd.sum(a, axis=1), [x])
    theirs, ours = both(lambda pkg: [
        pkg.nd.argmax(pkg.nd.array(x), axis=1),
        pkg.nd.argmin(pkg.nd.array(x), axis=2)])
    np.testing.assert_array_equal(ours[0], np.argmax(x, axis=1))
    np.testing.assert_array_equal(ours[1], np.argmin(x, axis=2))
    close(ours, theirs)


def test_dot_and_batch_dot():
    rng = np.random.RandomState(3)
    a, b = rng.randn(4, 5).astype(np.float32), rng.randn(5, 3).astype(
        np.float32)
    ba, bb = rng.randn(2, 4, 5).astype(np.float32), rng.randn(2, 5, 3).astype(
        np.float32)
    theirs, ours = both(lambda pkg: [
        pkg.nd.dot(pkg.nd.array(a), pkg.nd.array(b)),
        pkg.nd.batch_dot(pkg.nd.array(ba), pkg.nd.array(bb))])
    np.testing.assert_allclose(ours[0], a @ b, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ours[1], ba @ bb, rtol=1e-4, atol=1e-6)
    close(ours, theirs)
    check_grads(lambda pkg, x, y: pkg.nd.dot(x, y), [a, b])


def test_transpose_reshape_slice():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    theirs, ours = both(lambda pkg: [
        pkg.nd.transpose(pkg.nd.array(x)),
        pkg.nd.transpose(pkg.nd.array(x), axes=(1, 0, 2)),
        pkg.nd.reshape(pkg.nd.array(x), shape=(4, 6)),
        pkg.nd.slice_axis(pkg.nd.array(x), axis=1, begin=1, end=3),
        pkg.nd.flip(pkg.nd.array(x), axis=1)])
    want = [x.T, x.transpose(1, 0, 2), x.reshape(4, 6), x[:, 1:3],
            x[:, ::-1]]
    for got, w in zip(ours, want):
        np.testing.assert_array_equal(got, w)
    close(ours, theirs)


def test_take_one_hot_pick_where():
    rng = np.random.RandomState(4)
    x = rng.randn(5, 3).astype(np.float32)
    idx = np.array([0, 3, 1], dtype=np.float32)
    pick = np.array([0, 1, 2, 0, 1], dtype=np.float32)
    cond = np.array([[1, 0, 1], [0, 1, 0]], dtype=np.float32)
    theirs, ours = both(lambda pkg: [
        pkg.nd.take(pkg.nd.array(x), pkg.nd.array(idx)),
        pkg.nd.one_hot(pkg.nd.array(idx), depth=5),
        pkg.nd.pick(pkg.nd.array(x), pkg.nd.array(pick), axis=1),
        pkg.nd.where(pkg.nd.array(cond), pkg.nd.array(np.ones((2, 3))),
                     pkg.nd.array(np.zeros((2, 3))))])
    np.testing.assert_array_equal(ours[0], x[idx.astype(int)])
    np.testing.assert_array_equal(ours[1], np.eye(5)[idx.astype(int)])
    np.testing.assert_array_equal(ours[2], x[np.arange(5), [0, 1, 2, 0, 1]])
    np.testing.assert_array_equal(ours[3], cond)
    close(ours, theirs)


def test_topk_sort_argsort():
    x = np.random.RandomState(5).randn(3, 6).astype(np.float32)
    theirs, ours = both(lambda pkg: [
        pkg.nd.topk(pkg.nd.array(x), k=2, axis=1),
        pkg.nd.sort(pkg.nd.array(x), axis=1),
        pkg.nd.argsort(pkg.nd.array(x), axis=1)])
    np.testing.assert_array_equal(ours[0], np.argsort(-x, axis=1)[:, :2])
    np.testing.assert_array_equal(ours[1], np.sort(x, axis=1))
    np.testing.assert_array_equal(ours[2], np.argsort(x, axis=1))
    close(ours, theirs)


def test_softmax_log_softmax():
    x = np.random.RandomState(6).randn(4, 7).astype(np.float32)
    e = np.exp(x - x.max(axis=1, keepdims=True))
    ref = e / e.sum(axis=1, keepdims=True)
    theirs, ours = both(lambda pkg: [pkg.nd.softmax(pkg.nd.array(x)),
                                     pkg.nd.log_softmax(pkg.nd.array(x))])
    np.testing.assert_allclose(ours[0], ref, rtol=1e-4)
    np.testing.assert_allclose(ours[1], np.log(ref), rtol=1e-4)
    close(ours, theirs)
    check_grads(lambda pkg, a: pkg.nd.softmax(a) * pkg.nd.array(
        np.arange(7.0), dtype=a.dtype), [x])


def test_fully_connected_grad():
    rng = np.random.RandomState(7)
    x, w, b = (rng.randn(4, 6).astype(np.float32),
               rng.randn(3, 6).astype(np.float32),
               rng.randn(3).astype(np.float32))
    theirs, ours = both(lambda pkg: pkg.nd.FullyConnected(
        pkg.nd.array(x), pkg.nd.array(w), pkg.nd.array(b), num_hidden=3))
    np.testing.assert_allclose(ours, x @ w.T + b, rtol=1e-4, atol=1e-5)
    close(ours, theirs)
    check_grads(lambda pkg, a, ww, bb: pkg.nd.FullyConnected(
        a, ww, bb, num_hidden=3), [x, w, b])


def test_convolution_grad():
    rng = np.random.RandomState(8)
    x, w, b = (rng.randn(2, 3, 7, 7).astype(np.float32),
               rng.randn(4, 3, 3, 3).astype(np.float32),
               rng.randn(4).astype(np.float32))
    check_grads(lambda pkg, a, ww, bb: pkg.nd.Convolution(
        a, ww, bb, kernel=(3, 3), num_filter=4, pad=(1, 1)), [x, w, b],
        fd=False)


def test_batchnorm_inference_matches_numpy():
    rng = np.random.RandomState(9)
    x = rng.randn(4, 3, 5, 5).astype(np.float32)
    gamma, beta = rng.uniform(0.5, 1.5, 3), rng.randn(3)
    mean, var = rng.randn(3), rng.uniform(0.5, 1.5, 3)
    theirs, ours = both(lambda pkg: pkg.nd.BatchNorm(
        *[pkg.nd.array(a) for a in (x, gamma, beta, mean, var)],
        fix_gamma=False, use_global_stats=True, eps=1e-5))
    c = (slice(None), None, None)
    ref = ((x - mean[c]) / np.sqrt(var[c] + 1e-5) * gamma[c] + beta[c])
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-4)
    close(ours, theirs)


def test_check_symbolic_forward_backward():
    rng = np.random.RandomState(10)
    av, bv = rng.randn(3, 4).astype(np.float32), rng.randn(3, 4).astype(
        np.float32)

    def run(pkg):
        a, b = pkg.sym.var("a"), pkg.sym.var("b")
        out = 2 * a + a * b
        args = {"a": pkg.nd.array(av), "b": pkg.nd.array(bv)}
        g = {"a": pkg.nd.zeros((3, 4)), "b": pkg.nd.zeros((3, 4))}
        exe = out.bind(pkg.cpu(), args, args_grad=g)
        fwd = exe.forward(is_train=True)[0]
        exe.backward([pkg.nd.ones((3, 4))])
        return [fwd, g["a"], g["b"]]
    theirs, ours = both(run)
    np.testing.assert_allclose(ours[0], 2 * av + av * bv, rtol=1e-5)
    np.testing.assert_allclose(ours[1], 2 + bv, rtol=1e-5)
    np.testing.assert_allclose(ours[2], av, rtol=1e-5)
    close(ours, theirs)


def test_check_numeric_gradient_symbol_path():
    """The Symbol path gives real (non-zero) gradients, equal to finite
    differences of the bound graph's sum."""
    rng = np.random.RandomState(11)
    av = rng.uniform(0.5, 1.5, (3, 4)).astype(np.float32)
    bv = rng.uniform(0.5, 1.5, (3, 4)).astype(np.float32)

    def run(pkg, dtype="float32", a_val=av, b_val=bv):
        a, b = pkg.sym.var("a"), pkg.sym.var("b")
        out = pkg.sym.sum(pkg.sym.broadcast_mul(a, b) + a)
        args = {"a": pkg.nd.array(a_val, dtype=dtype),
                "b": pkg.nd.array(b_val, dtype=dtype)}
        g = {"a": pkg.nd.zeros((3, 4), dtype=dtype),
             "b": pkg.nd.zeros((3, 4), dtype=dtype)}
        exe = out.bind(pkg.cpu(), args, args_grad=g)
        fwd = exe.forward(is_train=True)[0]
        exe.backward([pkg.nd.ones(fwd.shape, dtype=dtype)])
        return [fwd, g["a"], g["b"]]
    theirs, ours = both(run)
    close(ours, theirs, **GRAD_PARITY)
    assert np.abs(ours[1]).sum() > 0 and np.abs(ours[2]).sum() > 0
    eps = 1e-6
    for k, name in ((1, "a"), (2, "b")):
        base = {"a": av.astype(np.float64), "b": bv.astype(np.float64)}
        fd = np.zeros((3, 4))
        for j in range(12):
            vals = []
            for sign in (1, -1):
                moved = {n: v.copy() for n, v in base.items()}
                moved[name].reshape(-1)[j] += sign * eps
                with mt.cpu():
                    vals.append(float(run(mt, "float64", moved["a"],
                                          moved["b"])[0].asscalar()))
            fd.reshape(-1)[j] = (vals[0] - vals[1]) / (2 * eps)
        np.testing.assert_allclose(ours[k], fd, rtol=1e-4, atol=1e-4)


def test_random_ops_statistics():
    """The reference's bounds on 20000 draws of each sampler (the streams
    differ, so each package is held to the bounds on its own)."""
    for pkg in (mx, mt):
        with pkg.cpu():
            pkg.random.seed(7)
            u = pkg.nd.random.uniform(0, 1, shape=(20000,)).asnumpy()
            assert 0.48 < u.mean() < 0.52
            n = pkg.nd.random.normal(0, 1, shape=(20000,)).asnumpy()
            assert abs(n.mean()) < 0.03 and 0.95 < n.std() < 1.05
            p = pkg.nd.random.poisson(lam=4.0, shape=(20000,)).asnumpy()
            assert 3.8 < p.mean() < 4.2
            g = pkg.nd.random.gamma(alpha=3.0, beta=1.0,
                                    shape=(20000,)).asnumpy()
            assert 2.8 < g.mean() < 3.2


def test_clip_round_sign():
    x = np.random.RandomState(12).uniform(-3, 3, (4, 5)).astype(np.float32)
    theirs, ours = both(lambda pkg: [
        pkg.nd.clip(pkg.nd.array(x), -1, 1), pkg.nd.sign(pkg.nd.array(x)),
        pkg.nd.round(pkg.nd.array(x)), pkg.nd.floor(pkg.nd.array(x)),
        pkg.nd.ceil(pkg.nd.array(x))])
    for got, want in zip(ours, [np.clip(x, -1, 1), np.sign(x), np.round(x),
                                np.floor(x), np.ceil(x)]):
        np.testing.assert_array_equal(got, want)
    close(ours, theirs)


# ---- tests/test_operator_indexing.py -------------------------------------
def test_take_axis0_matches_numpy():
    src = np.random.RandomState(13).randn(6, 4).astype(np.float32)
    idx = np.array([0, 5, 2], np.float32)
    theirs, ours = both(lambda pkg: pkg.nd.take(pkg.nd.array(src),
                                                pkg.nd.array(idx)))
    np.testing.assert_array_equal(ours, src[[0, 5, 2]])
    close(ours, theirs)


def test_batch_take():
    src = np.random.RandomState(14).randn(3, 5).astype(np.float32)
    idx = np.array([1, 0, 4], np.float32)
    theirs, ours = both(lambda pkg: pkg.nd.batch_take(pkg.nd.array(src),
                                                      pkg.nd.array(idx)))
    np.testing.assert_array_equal(ours, src[np.arange(3), [1, 0, 4]])
    close(ours, theirs)


def test_gather_scatter_nd_roundtrip():
    data = np.random.RandomState(15).randn(4, 5).astype(np.float32)
    indices = np.array([[0, 2, 3], [1, 4, 0]], np.float32)

    def run(pkg):
        picked = pkg.nd.gather_nd(pkg.nd.array(data), pkg.nd.array(indices))
        return [picked, pkg.nd.scatter_nd(picked, pkg.nd.array(indices),
                                          shape=(4, 5))]
    theirs, ours = both(run)
    np.testing.assert_array_equal(ours[0], data[[0, 2, 3], [1, 4, 0]])
    expect = np.zeros((4, 5))
    expect[[0, 2, 3], [1, 4, 0]] = ours[0]
    np.testing.assert_array_equal(ours[1], expect)
    close(ours, theirs)


def test_one_hot_and_pick_inverse():
    labels = np.array([0, 3, 1], np.float32)
    probs = np.random.RandomState(16).rand(3, 4).astype(np.float32)
    theirs, ours = both(lambda pkg: [
        pkg.nd.one_hot(pkg.nd.array(labels), depth=4),
        pkg.nd.pick(pkg.nd.array(probs), pkg.nd.array(labels), axis=1)])
    np.testing.assert_array_equal(ours[0].argmax(axis=1), labels)
    np.testing.assert_array_equal(ours[1], probs[np.arange(3), [0, 3, 1]])
    close(ours, theirs)


@pytest.mark.parametrize("k", [1, 3])
def test_topk_matches_numpy(k):
    x = np.random.RandomState(17).randn(4, 7).astype(np.float32)
    theirs, ours = both(lambda pkg: pkg.nd.topk(pkg.nd.array(x), k=k,
                                                ret_typ="value"))
    np.testing.assert_allclose(ours, np.sort(x, axis=1)[:, ::-1][:, :k],
                               rtol=1e-6)
    close(ours, theirs)


def test_sort_and_argsort():
    x = np.random.RandomState(18).randn(3, 6).astype(np.float32)
    theirs, ours = both(lambda pkg: [pkg.nd.sort(pkg.nd.array(x)),
                                     pkg.nd.argsort(pkg.nd.array(x))])
    np.testing.assert_array_equal(ours[0], np.sort(x, axis=-1))
    np.testing.assert_array_equal(ours[1], np.argsort(x, axis=-1,
                                                      kind="stable"))
    close(ours, theirs)


def test_where_broadcast_and_grad():
    rng = np.random.RandomState(19)
    cond = np.array([[1, 0], [0, 1]], np.float32)
    a, b = rng.randn(2, 2).astype(np.float32), rng.randn(2, 2).astype(
        np.float32)
    theirs, ours = both(lambda pkg: pkg.nd.where(
        pkg.nd.array(cond), pkg.nd.array(a), pkg.nd.array(b)))
    np.testing.assert_array_equal(ours, np.where(cond > 0, a, b))
    close(ours, theirs)
    check_grads(lambda pkg, x, y: pkg.nd.where(
        pkg.nd.array(cond, dtype=x.dtype), x, y), [a, b])


def test_sequence_mask_last_reverse():
    x = np.arange(24, dtype=np.float32).reshape(4, 2, 3)
    lengths = np.array([2, 4], np.float32)
    theirs, ours = both(lambda pkg: [
        getattr(pkg.nd, op)(pkg.nd.array(x), pkg.nd.array(lengths),
                            use_sequence_length=True, **kw)
        for op, kw in (("SequenceMask", {"value": -1.0}),
                       ("SequenceLast", {}), ("SequenceReverse", {}))])
    masked, last, rev = ours
    np.testing.assert_array_equal(masked[:2, 0], x[:2, 0])
    assert (masked[2:, 0] == -1.0).all()
    np.testing.assert_array_equal(masked[:, 1], x[:, 1])
    np.testing.assert_array_equal(last[0], x[1, 0])
    np.testing.assert_array_equal(last[1], x[3, 1])
    np.testing.assert_array_equal(rev[0, 0], x[1, 0])
    np.testing.assert_array_equal(rev[1, 0], x[0, 0])
    np.testing.assert_array_equal(rev[2:, 0], x[2:, 0])
    np.testing.assert_array_equal(rev[:, 1], x[::-1, 1])
    close(ours, theirs)


def test_reverse_tile_repeat():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    theirs, ours = both(lambda pkg: [
        pkg.nd.reverse(pkg.nd.array(x), axis=1),
        pkg.nd.tile(pkg.nd.array(x), reps=(2, 1)),
        pkg.nd.repeat(pkg.nd.array(x), repeats=2, axis=0)])
    for got, want in zip(ours, [x[:, ::-1], np.tile(x, (2, 1)),
                                np.repeat(x, 2, axis=0)]):
        np.testing.assert_array_equal(got, want)
    close(ours, theirs)


def test_embedding_grad_is_row_scatter():
    """Embedding's backward adds up the rows of repeated indices."""
    weight = np.random.RandomState(20).randn(5, 3).astype(np.float32)
    idx = np.array([1, 1, 4], np.float32)

    def run(pkg):
        w = pkg.nd.array(weight)
        w.attach_grad()
        with pkg.autograd.record():
            loss = pkg.nd.Embedding(pkg.nd.array(idx), w, input_dim=5,
                                    output_dim=3).sum()
        loss.backward()
        return w.grad
    theirs, ours = both(run)
    np.testing.assert_array_equal(ours[1], 2.0)
    np.testing.assert_array_equal(ours[4], 1.0)
    np.testing.assert_array_equal(ours[[0, 2, 3]], 0.0)
    close(ours, theirs)


# ---- tests/test_operator_extended.py -------------------------------------
def _rand(*shape):
    return np.random.RandomState(sum(shape) * 7 + len(shape)).rand(
        *shape).astype(np.float32)


def test_svm_output_forward_and_margin_grad():
    """SVMOutput's forward is the identity; its backward the hinge rule."""
    x = _rand(8, 5) * 2 - 1
    y = np.array([0, 1, 2, 3, 4, 0, 1, 2], np.float32)

    def run(pkg):
        sym = pkg.sym.SVMOutput(pkg.sym.Variable("data"),
                                label=pkg.sym.Variable("label"), margin=1.0,
                                regularization_coefficient=1.0)
        args = {"data": pkg.nd.array(x), "label": pkg.nd.array(y)}
        g = {"data": pkg.nd.zeros((8, 5))}
        exe = sym.bind(pkg.cpu(), args, args_grad=g,
                       grad_req={"data": "write", "label": "null"})
        out = exe.forward(is_train=True)[0]
        exe.backward()
        return [out, g["data"]]
    theirs, ours = both(run)
    np.testing.assert_allclose(ours[0], x, rtol=1e-5)
    g = ours[1]
    assert np.abs(g).sum() > 0
    for i, yi in enumerate(y.astype(int)):
        assert g[i, yi] <= 1e-6
        assert (np.delete(g[i], yi) >= -1e-6).all()
    close(ours, theirs)


def test_instance_norm_normalizes_per_instance():
    x = _rand(4, 3, 8, 8) * 5 + 2
    theirs, ours = both(lambda pkg: pkg.nd.InstanceNorm(
        pkg.nd.array(x), pkg.nd.ones((3,)), pkg.nd.zeros((3,)), eps=1e-5))
    np.testing.assert_allclose(ours.mean(axis=(2, 3)), 0, atol=1e-4)
    np.testing.assert_allclose(ours.std(axis=(2, 3)), 1, atol=1e-3)
    close(ours, theirs, rtol=1e-5, atol=1e-5)


def test_l2_normalization_modes():
    x = _rand(4, 3, 5, 5) + 0.1
    for mode, axes in (("instance", (1, 2, 3)), ("channel", (1,)),
                       ("spatial", (2, 3))):
        theirs, ours = both(lambda pkg: pkg.nd.L2Normalization(
            pkg.nd.array(x), mode=mode))
        norm = np.sqrt((x.astype(np.float64) ** 2).sum(axis=axes,
                                                       keepdims=True))
        np.testing.assert_allclose(ours, x / norm, rtol=1e-4, atol=1e-5)
        close(ours, theirs)


def test_lrn_matches_formula():
    x = _rand(2, 6, 4, 4)
    alpha, beta, knorm, nsize = 1e-4, 0.75, 2.0, 3
    theirs, ours = both(lambda pkg: pkg.nd.LRN(
        pkg.nd.array(x), alpha=alpha, beta=beta, knorm=knorm, nsize=nsize))
    expect = np.empty_like(x)
    for c in range(6):
        lo, hi = max(0, c - 1), min(6, c + 2)
        sq = (x[:, lo:hi] ** 2).sum(axis=1)
        expect[:, c] = x[:, c] / (knorm + alpha * sq) ** beta
    np.testing.assert_allclose(ours, expect, rtol=1e-4, atol=1e-5)
    close(ours, theirs)


def test_pad_modes_match_numpy():
    x = _rand(2, 3, 4, 5)
    pw = (0, 0, 0, 0, 1, 2, 2, 1)
    np_pad = ((0, 0), (0, 0), (1, 2), (2, 1))
    theirs, ours = both(lambda pkg: [
        pkg.nd.Pad(pkg.nd.array(x), mode="constant", pad_width=pw,
                   constant_value=3.5),
        pkg.nd.Pad(pkg.nd.array(x), mode="edge", pad_width=pw),
        pkg.nd.Pad(pkg.nd.array(x), mode="reflect", pad_width=pw)])
    for got, mode in zip(ours, ("constant", "edge", "reflect")):
        kw = {"constant_values": 3.5} if mode == "constant" else {}
        np.testing.assert_array_equal(got, np.pad(x, np_pad, mode=mode,
                                                  **kw))
    close(ours, theirs)


def test_crop_center_and_offset():
    x = _rand(1, 1, 8, 8)
    theirs, ours = both(lambda pkg: [
        pkg.nd.Crop(pkg.nd.array(x), h_w=(4, 4), center_crop=True),
        pkg.nd.Crop(pkg.nd.array(x), h_w=(4, 4), offset=(1, 3))])
    np.testing.assert_array_equal(ours[0][0, 0], x[0, 0, 2:6, 2:6])
    np.testing.assert_array_equal(ours[1][0, 0], x[0, 0, 1:5, 3:7])
    close(ours, theirs)


def test_upsampling_nearest_matches_repeat():
    x = _rand(2, 3, 4, 4)
    theirs, ours = both(lambda pkg: pkg.nd.UpSampling(
        pkg.nd.array(x), scale=2, sample_type="nearest"))
    np.testing.assert_array_equal(ours, x.repeat(2, axis=2).repeat(2,
                                                                    axis=3))
    close(ours, theirs)


def test_smooth_l1_piecewise():
    x = np.array([-2.0, -0.5, 0.0, 0.5, 2.0], np.float32)
    theirs, ours = both(lambda pkg: pkg.nd.smooth_l1(pkg.nd.array(x),
                                                     scalar=1.0))
    np.testing.assert_allclose(ours, np.where(np.abs(x) < 1.0, 0.5 * x ** 2,
                                              np.abs(x) - 0.5), rtol=1e-5)
    close(ours, theirs)


def test_special_math_functions():
    x = _rand(10) * 4 + 0.5
    theirs, ours = both(lambda pkg: [pkg.nd.gamma(pkg.nd.array(x)),
                                     pkg.nd.gammaln(pkg.nd.array(x))])
    np.testing.assert_allclose(ours[0], sp.gamma(x), rtol=1e-3)
    np.testing.assert_allclose(ours[1], sp.gammaln(x), rtol=1e-3, atol=1e-5)
    close(ours, theirs, rtol=1e-5, atol=1e-5)


def test_dropout_train_vs_inference():
    """A bound Dropout zeroes about half in training and scales the rest
    by 2; at inference it is the identity (the masks differ between the
    packages: their generators do)."""
    for pkg in (mx, mt):
        with pkg.cpu():
            sym = pkg.sym.Dropout(pkg.sym.Variable("data"), p=0.5)
            exe = sym.bind(pkg.cpu(), {"data": pkg.nd.ones((200, 200))})
            train_out = exe.forward(is_train=True)[0].asnumpy()
            assert 0.4 < (train_out == 0).mean() < 0.6
            kept = train_out[train_out != 0]
            np.testing.assert_array_equal(kept, 2.0)
            np.testing.assert_array_equal(
                exe.forward(is_train=False)[0].asnumpy(), 1.0)


# ---- tests/test_operator_zoo.py ------------------------------------------
def test_deconvolution_inverts_shape():
    rng = np.random.RandomState(21)
    x, w = rng.randn(1, 3, 5, 5).astype(np.float32), rng.randn(
        3, 4, 3, 3).astype(np.float32)
    theirs, ours = both(lambda pkg: pkg.nd.Deconvolution(
        pkg.nd.array(x), pkg.nd.array(w), kernel=(3, 3), stride=(2, 2),
        num_filter=4, no_bias=True))
    assert ours.shape == (1, 4, (5 - 1) * 2 + 3, (5 - 1) * 2 + 3)
    close(ours, theirs, rtol=1e-5, atol=1e-5)


_ELEMWISE = ["relu", "sigmoid", "tanh", "exp", "sqrt", "square"]


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("opname", _ELEMWISE)
def test_unary_low_precision_consistency(dtype, opname):
    """The 16-bit forward within 2e-2 of fp32 (the reference's bound), and
    within one 16-bit rounding of the JAX package's 16-bit result."""
    x32 = np.abs(np.random.RandomState(22).randn(4, 16).astype(
        np.float32)) + 0.1

    def run(pkg):
        fn = getattr(pkg.nd, opname)
        return [fn(pkg.nd.array(x32)),
                fn(pkg.nd.array(x32).astype(dtype)).astype("float32")]
    theirs, ours = both(run)
    np.testing.assert_allclose(ours[1], ours[0], rtol=2e-2, atol=2e-2)
    close(ours[1], theirs[1], **BF16_TOL)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_fc_low_precision_consistency(dtype):
    rng = np.random.RandomState(23)
    x = rng.randn(8, 32).astype(np.float32)
    w = (rng.randn(16, 32) * 0.1).astype(np.float32)
    b = np.zeros(16, np.float32)

    def run(pkg):
        args = [pkg.nd.array(a) for a in (x, w, b)]
        return [pkg.nd.FullyConnected(*args, num_hidden=16),
                pkg.nd.FullyConnected(*[a.astype(dtype) for a in args],
                                      num_hidden=16).astype("float32")]
    theirs, ours = both(run)
    np.testing.assert_allclose(ours[1], ours[0], rtol=5e-2, atol=5e-2)
    # a 32-term dot rounded once (fp32 accumulation in both)
    close(ours[1], theirs[1], rtol=2.0 ** -6, atol=2.0 ** -6)


NUMERIC_ZOO = {
    "tanh": lambda F, d: F.Activation(d, act_type="tanh"),
    "leaky": lambda F, d: F.LeakyReLU(d, act_type="leaky", slope=0.1),
    "log_softmax": lambda F, d: F.log_softmax(d),
    "l2norm": lambda F, d: F.L2Normalization(d),
    "sum_mul": lambda F, d: F.sum(F.broadcast_mul(d, d)),
}


@pytest.mark.parametrize("name", sorted(NUMERIC_ZOO))
def test_numeric_gradient_zoo(name):
    """Gradients through a bound Symbol against the JAX package's and
    against finite differences in fp64."""
    loc = np.random.RandomState(24).randn(3, 7) * 0.5
    fn = NUMERIC_ZOO[name]
    check_grads(lambda pkg, d: fn(pkg.nd, d) * pkg.nd.array(
        np.linspace(0.5, 1.5, 21).reshape(3, 7) if name != "sum_mul"
        else np.ones(1), dtype=d.dtype), [loc.astype(np.float32)])
    theirs, ours = both(lambda pkg: _bound_grads(pkg, fn, {"data": loc}))
    close(ours, theirs, **GRAD_PARITY)


def _bound_grads(pkg, fn, loc):
    """The gradient of sum(output) through ``simple_bind``."""
    data = {n: pkg.sym.Variable(n) for n in loc}
    sym = fn(pkg.sym, *data.values())
    exe = sym.simple_bind(pkg.cpu(), **{n: v.shape for n, v in loc.items()})
    for n, v in loc.items():
        exe.arg_dict[n][:] = v.astype(np.float32)
    out = exe.forward(is_train=True)[0]
    exe.backward([pkg.nd.ones(out.shape)])
    return [exe.grad_dict[n] for n in loc]


def test_numeric_gradient_conv():
    rng = np.random.RandomState(25)
    x, w = rng.randn(1, 2, 5, 5) * 0.5, rng.randn(2, 2, 3, 3) * 0.5
    check_grads(lambda pkg, d, ww: pkg.nd.Convolution(
        d, ww, kernel=(3, 3), num_filter=2, no_bias=True),
        [x.astype(np.float32), w.astype(np.float32)])


def test_numeric_gradient_batchnorm_like():
    rng = np.random.RandomState(26)
    loc = [rng.randn(2, 3, 3, 3) * 0.5 + 1.0, rng.rand(3) + 0.5,
           rng.randn(3) * 0.1]
    weights = np.linspace(-1, 1, 54).reshape(2, 3, 3, 3)
    check_grads(lambda pkg, d, g, b: pkg.nd.InstanceNorm(d, g, b)
                * pkg.nd.array(weights, dtype=d.dtype),
                [a.astype(np.float32) for a in loc], fd_tol=1e-3)


# ---- the op sweep (elemwise and reduce) ----------------------------------
def _module(case):
    return OP_REGISTRY[case["op"]].fn.__module__.rsplit(".", 1)[-1]


CASES = [c for c in op_cases() if _module(c) in SWEEP_MODULES]


def check_case(case, dtype):
    tol = case["tol"] if dtype == "float32" else BF16_TOL
    with mx.cpu():
        want = run_op_case(mx, case, mx.cpu(), dtype)
    got = run_op_case(mt, case, mt.cpu(), dtype)
    for k, (g, w) in enumerate(zip(got[0] + got[1], want[0] + want[1])):
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg="%s item %d"
                                   % (case["name"], k), **tol)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_op_sweep(case):
    check_case(case, "float32")


BF16_CASES = [c for c in CASES if c["bf16"]]


@pytest.mark.parametrize("case", BF16_CASES,
                         ids=[c["name"] for c in BF16_CASES])
def test_op_sweep_bf16(case):
    check_case(case, "bfloat16")


def test_sweep_covers_every_op():
    """Every distinct op of the elemwise, reduce, matrix and nn modules has
    a case in the sweep."""
    covered = {id(OP_REGISTRY[c["op"]]) for c in op_cases()}
    missing = sorted(n for n, op in OP_REGISTRY.items()
                     if op.fn.__module__.rsplit(".", 1)[-1] in (
                         "elemwise", "reduce", "matrix", "nn")
                     and id(op) not in covered)
    assert not missing
