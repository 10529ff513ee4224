"""``Convolution``, ``Pooling``, ``BatchNorm``, ``Cast`` and ``add_n`` of
the PyTorch package against the JAX package's ops on the CPU: the same
seeded numpy inputs through ``mxnet_tpu.nd.<op>`` and
``mxnet_tpu_torch.nd.<op>``, forward and the gradients of every
differentiable input under a seeded head gradient.

Tolerances.  fp32: atol 1e-5 and rtol 1e-5 (the same arithmetic, summed
in other orders).  bf16 (BatchNorm, Cast, add_n): both packages round
every op's result to bf16 but at different places (XLA on the CPU keeps
a fused chain in fp32 and rounds once; torch rounds after each op), so
values of magnitude up to 4 may differ by a unit or two in bf16's last
place (2^-7 relative): atol 0.0625, rtol 2^-6.
"""
import itertools

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

FP32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=0.0625, rtol=2.0 ** -6)


def _run(pkg, op, arrays, attrs, diff, head, dtype="float32", train=True):
    """op(*arrays, **attrs) in ``pkg`` with gradients of the inputs at
    ``diff``; returns (numpy outputs of the visible result, numpy
    gradients, numpy values of every input after the call)."""
    ctx = pkg.cpu()
    nds = [pkg.nd.array(a, ctx=ctx, dtype=dtype) for a in arrays]
    for i in diff:
        nds[i].attach_grad()
    with pkg.autograd.record(train_mode=train):
        out = getattr(pkg.nd, op)(*nds, **attrs)
    if diff:
        out.backward(pkg.nd.array(head, ctx=ctx, dtype=dtype))

    def host(x):
        return np.asarray(x.astype("float32").asnumpy(), np.float32)
    return host(out), [host(nds[i].grad) for i in diff], [host(x) for x in nds]


def _check(op, arrays, attrs, diff, tol=FP32, dtype="float32", train=True):
    rng = np.random.RandomState(7)
    ref = _run(mx, op, arrays, attrs, [], None, dtype, train)
    head = rng.randn(*ref[0].shape).astype(np.float32)
    want = _run(mx, op, arrays, attrs, diff, head, dtype, train)
    got = _run(mt, op, arrays, attrs, diff, head, dtype, train)
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], err_msg="forward", **tol)
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        np.testing.assert_allclose(g, w, err_msg="grad of input %d"
                                   % diff[i], **tol)
    return got, want


# (kernel, stride, pad, dilate, num_group, no_bias)
CONV_CASES = [
    ((1, 1), (1, 1), (0, 0), (1, 1), 1, False),
    ((1, 1), (2, 2), (0, 0), (1, 1), 1, True),
    ((3, 3), (1, 1), (1, 1), (1, 1), 1, False),
    ((3, 3), (2, 2), (1, 1), (1, 1), 1, True),
    ((7, 7), (2, 2), (3, 3), (1, 1), 1, True),
    ((3, 3), (1, 1), (2, 2), (2, 2), 1, False),
    ((3, 3), (1, 1), (1, 1), (1, 1), 2, False),
    ((3, 3), (2, 2), (0, 0), (2, 2), 2, True),
]


@pytest.mark.parametrize("kernel,stride,pad,dilate,group,no_bias",
                         CONV_CASES)
def test_convolution(kernel, stride, pad, dilate, group, no_bias):
    rng = np.random.RandomState(0)
    c_in, c_out = 4, 6
    x = rng.randn(2, c_in, 15, 13).astype(np.float32)
    w = (rng.randn(c_out, c_in // group, *kernel) * 0.3).astype(np.float32)
    arrays = [x, w] if no_bias else [x, w, rng.randn(c_out).astype(
        np.float32)]
    _check("Convolution", arrays,
           dict(kernel=kernel, stride=stride, pad=pad, dilate=dilate,
                num_filter=c_out, num_group=group, no_bias=no_bias),
           list(range(len(arrays))))


def test_convolution_1d():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 17).astype(np.float32)
    w = rng.randn(5, 3, 3).astype(np.float32)
    _check("Convolution", [x, w], dict(kernel=(3,), stride=(2,), pad=(1,),
                                       num_filter=5, no_bias=True), [0, 1])


# (kernel, stride, pad): odd sizes 9 x 11, where "full" adds a window on
# the high side
POOL_WINDOWS = [((3, 3), (2, 2), (1, 1)), ((2, 2), (2, 2), (0, 0)),
                ((3, 2), (2, 3), (1, 0))]


@pytest.mark.parametrize("pool_type,convention,window,count_include_pad",
                         [c for c in itertools.product(
                             ("max", "avg", "sum"), ("valid", "full"),
                             POOL_WINDOWS, (True, False))
                          if c[0] == "avg" or c[3]])
def test_pooling(pool_type, convention, window, count_include_pad):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 9, 11).astype(np.float32)
    kernel, stride, pad = window
    got, _ = _check("Pooling", [x], dict(
        kernel=kernel, stride=stride, pad=pad, pool_type=pool_type,
        pooling_convention=convention, count_include_pad=count_include_pad),
        [0])
    if convention == "full" and window == POOL_WINDOWS[1]:
        assert got[0].shape == (2, 3, 5, 6)  # ceil(9/2), ceil(11/2)


@pytest.mark.parametrize("pool_type", ["max", "avg", "sum"])
def test_global_pooling_ignores_kernel_stride_pad(pool_type):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 7, 5).astype(np.float32)
    got, _ = _check("Pooling", [x], dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), global_pool=True,
        pool_type=pool_type), [0])
    assert got[0].shape == (2, 4, 1, 1)


def _bn_inputs(seed, c=5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(3, c, 4, 6) * 2 + 1).astype(np.float32),
            (rng.rand(c) + 0.5).astype(np.float32),
            rng.randn(c).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.rand(c) + 0.5).astype(np.float32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train,fix_gamma,use_global_stats",
                         [(True, False, False), (True, True, False),
                          (True, False, True), (False, False, False),
                          (False, True, False)])
def test_batchnorm(dtype, train, fix_gamma, use_global_stats):
    """Outputs, the gradients of data, gamma and beta, and the moving
    statistics written back into the aux inputs."""
    arrays = _bn_inputs(4)
    tol = FP32 if dtype == "float32" else BF16
    got, want = _check("BatchNorm", arrays, dict(
        eps=1e-3, momentum=0.9, fix_gamma=fix_gamma,
        use_global_stats=use_global_stats), [0, 1, 2], tol=tol,
        dtype=dtype, train=train)
    for i, name in ((3, "moving_mean"), (4, "moving_var")):
        np.testing.assert_allclose(got[2][i], want[2][i], err_msg=name,
                                   **tol)
    if fix_gamma:
        assert not got[1][1].any(), "fix_gamma: gamma's gradient is zero"
        assert got[1][2].any() and got[1][0].any()
    start = mt.nd.array(arrays[3], ctx=mt.cpu(), dtype=dtype)
    moved = (got[2][3] != start.astype("float32").asnumpy()).any()
    assert moved == (train and not use_global_stats)


def test_batchnorm_moving_stats_are_mxnet_momentum_and_biased_variance():
    """new = old * momentum + batch * (1 - momentum), with the batch's
    biased variance: not torch's F.batch_norm convention."""
    x, g, b, mm, mv = _bn_inputs(5)
    arrays = [mt.nd.array(a, ctx=mt.cpu()) for a in (x, g, b, mm, mv)]
    with mt.autograd.train_mode():
        mt.nd.BatchNorm(*arrays, momentum=0.8, fix_gamma=False)
    red = (0, 2, 3)
    np.testing.assert_allclose(arrays[3].asnumpy(),
                               mm * 0.8 + x.mean(red) * 0.2, rtol=1e-5)
    np.testing.assert_allclose(arrays[4].asnumpy(),
                               mv * 0.8 + x.var(red) * 0.2, rtol=1e-5)


@pytest.mark.parametrize("src,dst", [("float32", "bfloat16"),
                                     ("bfloat16", "float32"),
                                     ("float32", "float16"),
                                     ("float32", "float32")])
def test_cast(src, dst):
    rng = np.random.RandomState(6)
    x = (rng.randn(4, 7) * 3).astype(np.float32)
    outs = []
    for pkg in (mx, mt):
        a = pkg.nd.array(x, ctx=pkg.cpu(), dtype=src)
        a.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.Cast(a, dtype=dst)
        y.backward()
        outs.append((y.astype("float32").asnumpy(),
                     a.grad.astype("float32").asnumpy()))
    for g, w in zip(*outs[::-1]):
        np.testing.assert_array_equal(g, w)
    assert mt.nd.Cast(mt.nd.array(x, ctx=mt.cpu()), dtype=dst)._data.dtype \
        == mt.base.torch_dtype(dst)


@pytest.mark.parametrize("n,dtype", [(1, "float32"), (2, "float32"),
                                     (5, "float32"), (3, "bfloat16")])
@pytest.mark.parametrize("name", ["add_n", "ElementWiseSum"])
def test_add_n(n, dtype, name):
    rng = np.random.RandomState(8)
    arrays = [rng.randn(3, 4).astype(np.float32) for _ in range(n)]
    _check(name, arrays, dict(num_args=n), list(range(n)),
           tol=FP32 if dtype == "float32" else BF16, dtype=dtype)


def test_symbol_lists_conv_bn_names_and_infers_shapes():
    """``sym.Convolution``/``BatchNorm`` create the JAX package's variable
    names (aux states last) and ``simple_bind`` sizes them from data."""
    shapes = {}
    for pkg in (mx, mt):
        with pkg.name.NameManager():
            d = pkg.sym.var("data")
            c = pkg.sym.Convolution(d, kernel=(3, 3), num_filter=8,
                                    pad=(1, 1), name="c0")
            b = pkg.sym.BatchNorm(c, name="bn0")
            p = pkg.sym.Pooling(b, kernel=(2, 2), stride=(2, 2),
                                pool_type="max")
            s = pkg.sym.add_n(p, p, num_args=2)
        shapes[pkg] = (s.list_arguments(), s.list_auxiliary_states(),
                       s.infer_shape(data=(2, 3, 10, 10)))
    assert shapes[mt] == shapes[mx]
    assert shapes[mt][1] == ["bn0_moving_mean", "bn0_moving_var"]
