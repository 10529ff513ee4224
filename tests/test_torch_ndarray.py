"""NDArray, the op registry and the built-in ops of the PyTorch package
against the JAX package, on the same numpy inputs (fp32, on the CPU)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd

# elementwise and shape ops compute the same fp32 values in both packages
ATOL = 1e-6


def _rand(rng, shape, low=-2.0, high=2.0):
    return rng.uniform(low, high, shape).astype(np.float32)


def _shape(rng, ndim):
    return tuple(int(d) for d in rng.randint(1, 6, ndim))


def _both(name, arrays, **attrs):
    """Run op ``name`` through ``nd.<name>`` in both packages."""
    got = getattr(nd, name)(*[nd.array(a, ctx=mt.cpu()) for a in arrays],
                            **attrs)
    want = getattr(jnd, name)(*[jnd.array(a) for a in arrays], **attrs)
    return got.asnumpy(), want.asnumpy()


UNARY = ["relu", "negative"]
BINARY = ["elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
          "broadcast_add", "maximum", "minimum"]
SCALAR = ["_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
          "_div_scalar", "_rdiv_scalar", "_power_scalar", "_maximum_scalar",
          "_minimum_scalar", "_greater_scalar", "_lesser_equal_scalar"]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name", UNARY + BINARY + SCALAR)
def test_elementwise_matches_jax(name, seed):
    rng = np.random.RandomState(seed)
    shape = _shape(rng, 1 + seed)
    if name in UNARY:
        arrays, attrs = [_rand(rng, shape)], {}
    elif name in BINARY:
        arrays, attrs = [_rand(rng, shape), _rand(rng, shape, 0.5, 2.0)], {}
    else:
        arrays = [_rand(rng, shape, 0.5, 2.0)]
        attrs = {"scalar": float(rng.uniform(0.5, 2.0))}
    if name.startswith("_"):
        got = getattr(nd._internal, name)(nd.array(arrays[0], ctx=mt.cpu()),
                                          **attrs).asnumpy()
        want = getattr(mx.nd._internal, name)(jnd.array(arrays[0]),
                                              **attrs).asnumpy()
    else:
        got, want = _both(name, arrays, **attrs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("act_type", ["relu", "sigmoid", "tanh", "softrelu",
                                      "softsign"])
def test_activation_matches_jax(act_type):
    x = _rand(np.random.RandomState(1), (4, 7), -4.0, 4.0)
    got, want = _both("Activation", [x], act_type=act_type)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("name", ["sum", "mean"])
@pytest.mark.parametrize("axis,keepdims,exclude", [
    (None, False, False), (0, False, False), (1, True, False),
    ((0, 2), False, False), (1, False, True), ((), False, False)])
def test_reductions_match_jax(name, axis, keepdims, exclude):
    x = _rand(np.random.RandomState(2), (3, 4, 5))
    got, want = _both(name, [x], axis=axis, keepdims=keepdims,
                      exclude=exclude)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("name,attrs", [
    ("Flatten", {}),
    ("Reshape", {"shape": (0, -1)}),
    ("Reshape", {"shape": (-1, 6)}),
    ("Reshape", {"shape": (-2,)}),
    ("Reshape", {"shape": (-3, 0)}),
    ("Reshape", {"shape": (0, -4, 2, -1, 0)}),
    ("Reshape", {"shape": (-1, 5), "reverse": True}),
])
def test_shape_ops_match_jax(name, attrs):
    x = _rand(np.random.RandomState(3), (2, 6, 5))
    got, want = _both(name, [x], **attrs)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch,in_shape,hidden,no_bias,flatten", [
    (64, (784,), 128, False, True), (5, (3, 4), 7, False, True),
    (4, (6,), 3, True, True), (2, (3, 9), 4, False, False)])
def test_fully_connected_matches_jax(batch, in_shape, hidden, no_bias,
                                     flatten):
    rng = np.random.RandomState(batch)
    x = _rand(rng, (batch,) + in_shape)
    in_dim = int(np.prod(in_shape)) if flatten else in_shape[-1]
    arrays = [x, _rand(rng, (hidden, in_dim), -0.1, 0.1)]
    if not no_bias:
        arrays.append(_rand(rng, (hidden,)))
    got, want = _both("FullyConnected", arrays, num_hidden=hidden,
                      no_bias=no_bias, flatten=flatten)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_softmax_output_forward_matches_jax():
    rng = np.random.RandomState(4)
    x = _rand(rng, (8, 10), -5.0, 5.0)
    label = rng.randint(0, 10, 8).astype(np.float32)
    got, want = _both("SoftmaxOutput", [x, label])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("momentum,wd,clip", [(0.9, 0.0, None),
                                              (0.5, 1e-3, 0.05)])
def test_sgd_mom_update_writes_mom_back_in_place(momentum, wd, clip):
    rng = np.random.RandomState(5)
    w, g, m = (_rand(rng, (6, 4)) for _ in range(3))
    attrs = dict(lr=0.1, momentum=momentum, wd=wd, rescale_grad=1 / 64,
                 clip_gradient=-1.0 if clip is None else clip)
    weight, grad, mom = (nd.array(a, ctx=mt.cpu()) for a in (w, g, m))
    w_ptr, m_ptr = weight._data.data_ptr(), mom._data.data_ptr()
    out = nd.sgd_mom_update(weight, grad, mom, out=weight, **attrs)
    jw, jg, jm = (jnd.array(a) for a in (w, g, m))
    jnd.sgd_mom_update(jw, jg, jm, out=jw, **attrs)
    assert out is weight
    # the same tensors hold the new values: nothing was rebound
    assert weight._data.data_ptr() == w_ptr and mom._data.data_ptr() == m_ptr
    np.testing.assert_allclose(weight.asnumpy(), jw.asnumpy(), atol=ATOL)
    np.testing.assert_allclose(mom.asnumpy(), jm.asnumpy(), atol=ATOL)
    assert not np.allclose(mom.asnumpy(), m)


def test_sgd_update_matches_jax():
    rng = np.random.RandomState(6)
    w, g = _rand(rng, (5,)), _rand(rng, (5,))
    weight = nd.array(w, ctx=mt.cpu())
    nd.sgd_update(weight, nd.array(g, ctx=mt.cpu()), out=weight, lr=0.5,
                  wd=0.01)
    jw = jnd.array(w)
    jnd.sgd_update(jw, jnd.array(g), out=jw, lr=0.5, wd=0.01)
    np.testing.assert_allclose(weight.asnumpy(), jw.asnumpy(), atol=ATOL)


@pytest.mark.parametrize("op", ["+", "-", "*", "/", "**", "r+", "r-", "r*",
                                "r/", "neg", "==", ">", "<=", "%", "r%",
                                "r**"])
def test_ndarray_operators_match_jax(op):
    rng = np.random.RandomState(7)
    a, b = _rand(rng, (3, 4), 0.5, 2.0), _rand(rng, (3, 4), 0.5, 2.0)
    b[0, 0] = a[0, 0]
    fns = {"+": lambda x, y: x + y, "-": lambda x, y: x - y,
           "*": lambda x, y: x * y, "/": lambda x, y: x / y,
           "**": lambda x, y: x ** 1.5, "r+": lambda x, y: 2.0 + x,
           "r-": lambda x, y: 2.0 - x, "r*": lambda x, y: 2.0 * x,
           "r/": lambda x, y: 2.0 / x, "neg": lambda x, y: -x,
           "==": lambda x, y: x == y, ">": lambda x, y: x > y,
           "<=": lambda x, y: x <= 1.0, "%": lambda x, y: x % y,
           "r%": lambda x, y: 3.0 % x, "r**": lambda x, y: 1.5 ** x}
    got = fns[op](nd.array(a, ctx=mt.cpu()), nd.array(b, ctx=mt.cpu()))
    want = fns[op](jnd.array(a), jnd.array(b))
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6,
                               atol=ATOL)


def test_inplace_operators_and_setitem_keep_the_tensor():
    x = nd.array(np.ones((2, 3)), ctx=mt.cpu())
    ptr = x._data.data_ptr()
    x += 2.0
    x *= nd.array(np.full((2, 3), 3.0), ctx=mt.cpu())
    x[0] = 1.0
    x[1, 1:] = np.array([5.0, 6.0])
    assert x._data.data_ptr() == ptr
    np.testing.assert_array_equal(x.asnumpy(), [[1, 1, 1], [9, 5, 6]])
    assert x[1].asnumpy().tolist() == [9, 5, 6]


def test_constructors_and_dtypes():
    with mt.cpu():
        a = nd.array([1, 2, 3])
        assert a.dtype == np.float32 and a.context == mt.cpu()
        assert nd.array(a, dtype="float16").dtype == np.float16
        assert nd.zeros((2, 2)).asnumpy().sum() == 0
        assert nd.ones((2, 2), dtype=np.int32).dtype == np.int32
        assert nd.full((3,), 7.0).asnumpy().tolist() == [7.0] * 3
        assert nd.array(np.arange(4), dtype=torch.bfloat16).dtype \
            == torch.bfloat16
        assert mt.current_context() == mt.cpu()
    assert float(nd.array([2.5], ctx=mt.cpu())) == 2.5
    assert a.astype("float64").dtype == np.float64
    assert a.copyto(mt.cpu()).asnumpy().tolist() == [1, 2, 3]


def test_unknown_op_and_bad_context_raise():
    with pytest.raises(mt.MXNetError, match="not registered"):
        nd.invoke("no_such_op", [], {})
    with pytest.raises(mt.MXNetError):
        nd.array([1.0], ctx="meta")


def test_random_seed_makes_generators_repeat():
    mt.random.seed(3)
    a = torch.rand(4, generator=mt.random.generator(mt.cpu()))
    mt.random.seed(3)
    b = torch.rand(4, generator=mt.random.generator(mt.cpu()))
    mt.random.seed(5, ctx=mt.cpu())
    c = torch.rand(4, generator=mt.random.generator(mt.cpu()))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with mt.cpu():
        assert mt.random.generator() is mt.random.generator(mt.cpu())


# Results of indexing and of shape ops are copies in the JAX package (its
# arrays are immutable), and the port follows it: a write into the result
# leaves the parent unchanged.
DERIVED = {
    "first_axis_slice": lambda a, pkg: a[0:2],
    "column": lambda a, pkg: a[:, 1],
    "element_row": lambda a, pkg: a[1],
    "reshape_method": lambda a, pkg: a.reshape((4, 3)),
    "Reshape": lambda a, pkg: pkg.nd.Reshape(a, shape=(2, 6)),
    "Flatten": lambda a, pkg: pkg.nd.Flatten(a),
    "astype_same": lambda a, pkg: a.astype("float32"),
}


@pytest.mark.parametrize("kind", sorted(DERIVED))
def test_derived_arrays_are_copies_as_in_jax(kind):
    src = np.arange(12, dtype=np.float32).reshape(3, 4)
    parents = []
    for pkg in (mx, mt):
        a = pkg.nd.array(src, ctx=pkg.cpu())
        b = DERIVED[kind](a, pkg)
        b[:] = 5
        assert (b.asnumpy() == 5).all()
        parents.append(a.asnumpy())
    np.testing.assert_array_equal(parents[0], src)
    np.testing.assert_array_equal(parents[1], parents[0])


def test_gradients_through_slices_match_jax():
    """A slice and a column taken under ``autograd.record()`` still carry
    their gradients back to the parent, as in the JAX package."""
    rng = np.random.RandomState(0)
    x, w = _rand(rng, (3, 4)), _rand(rng, (2, 4))
    grads = []
    for pkg in (mx, mt):
        a = pkg.nd.array(x, ctx=pkg.cpu())
        a.attach_grad()
        with pkg.autograd.record():
            y = (a[0:2] * pkg.nd.array(w, ctx=pkg.cpu())).sum() \
                + (a[:, 1] * a[:, 1]).sum()
        y.backward()
        grads.append(a.grad.asnumpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=0, atol=ATOL)
    assert np.abs(grads[1]).max() > 0
