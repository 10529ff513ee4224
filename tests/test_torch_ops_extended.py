"""The spatial ops, linalg, the contrib transforms, CTC and the tensor
bridge against the JAX package on the CPU.

Case for case: ``tests/test_operator_extended.py``'s ROI pooling,
correlation, grid generator with the bilinear sampler, spatial
transformer, the three linalg cases, fft/ifft, quantize/dequantize and
count sketch; ``tests/test_operator_indexing.py::
test_bilinear_sampler_identity_grid``; ``tests/test_gluon.py::
test_ctc_loss``; ``tests/test_contrib_misc.py::
test_torch_bridge_roundtrip``.  Each runs in both packages and holds the
reference's own assertion (its numpy oracle and tolerance) for the port;
the port's results equal the JAX package's within 1e-5 relative (fp32
formulas in other summation orders; the factorisations through another
LAPACK build).  ``syevd``'s eigenvectors and ``gelqf``'s factors are
unique up to sign (ROADMAP "Not faults"): they are compared with their
signs made canonical, and through their reconstructions.
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.test_utils import canonical_signs

PARITY = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    prev = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_enable_x64", prev[0])
    torch.set_num_threads(prev[1])


def _rand(*shape):
    return np.random.RandomState(hash(shape) % 2**31).rand(
        *shape).astype(np.float32)


def _spd(n, k):
    a = np.random.RandomState(n * 10 + k).randn(n, k, k).astype(np.float32)
    return a @ a.transpose(0, 2, 1) + k * np.eye(k, dtype=np.float32)


def both(fn):
    """``fn(pkg)`` in both packages, its NDArray results as numpy."""
    def host(out):
        if isinstance(out, (list, tuple)):
            return [o.asnumpy() for o in out]
        return out.asnumpy()
    with mx.cpu():
        want = host(fn(mx))
    with mt.cpu():
        got = host(fn(mt))
    return want, got


def check(want, got, **tol):
    if isinstance(want, list):
        for w, g in zip(want, got):
            check(w, g, **tol)
        return
    assert np.shape(got) == np.shape(want)
    np.testing.assert_allclose(got, want, **(tol or PARITY))


def test_roipooling_max_pools_region():
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    rois = np.array([[0, 0, 0, 3, 3]], np.float32)
    want, out = both(lambda p: p.nd.ROIPooling(
        p.nd.array(x), p.nd.array(rois), pooled_size=(2, 2),
        spatial_scale=1.0))
    np.testing.assert_allclose(out[0, 0], [[5, 7], [13, 15]])
    check(want, out)


def test_correlation_self_peak_at_zero_displacement():
    x = _rand(1, 2, 6, 6)
    want, out = both(lambda p: p.nd.Correlation(
        p.nd.array(x), p.nd.array(x), kernel_size=1, max_displacement=1,
        stride1=1, stride2=1, pad_size=1))
    totals = out[0].sum(axis=(1, 2))
    assert totals[4] >= totals.max() - 1e-4
    check(want, out)


def test_grid_generator_affine_identity_plus_sampler():
    x = _rand(2, 3, 8, 8)
    ident = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (2, 1))

    def run(p):
        grid = p.nd.GridGenerator(p.nd.array(ident), transform_type="affine",
                                  target_shape=(8, 8))
        return p.nd.BilinearSampler(p.nd.array(x), grid)
    want, out = both(run)
    np.testing.assert_allclose(out, x, rtol=1e-4, atol=1e-4)
    check(want, out)


def test_spatial_transformer_identity():
    x = _rand(2, 3, 6, 6)
    loc = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (2, 1))
    want, out = both(lambda p: p.nd.SpatialTransformer(
        p.nd.array(x), p.nd.array(loc), target_shape=(6, 6),
        transform_type="affine", sampler_type="bilinear"))
    np.testing.assert_allclose(out, x, rtol=1e-4, atol=1e-4)
    check(want, out)


def test_linalg_potrf_potri_sumlogdiag():
    spd = _spd(2, 4)
    want, l = both(lambda p: p.nd.linalg_potrf(p.nd.array(spd)))
    np.testing.assert_allclose(l @ l.transpose(0, 2, 1), spd, rtol=1e-3,
                               atol=1e-3)
    assert (np.triu(l[0], 1) == 0).all()
    check(want, l)
    want, inv = both(lambda p: p.nd.linalg_potri(p.nd.array(l)))
    np.testing.assert_allclose(inv, np.linalg.inv(spd), rtol=1e-2,
                               atol=1e-3)
    check(want, inv)
    want, sld = both(lambda p: p.nd.linalg_sumlogdiag(
        p.nd.array(np.abs(l) + 1e-3)))
    expect = np.log(np.abs(np.diagonal(np.abs(l) + 1e-3, axis1=1,
                                       axis2=2))).sum(1)
    np.testing.assert_allclose(sld, expect, rtol=1e-4)
    check(want, sld)


def test_linalg_gemm_trmm_trsm():
    a, b = _rand(2, 3, 4), _rand(2, 3, 4)
    want, out = both(lambda p: p.nd.linalg_gemm2(
        p.nd.array(a), p.nd.array(b), transpose_b=True))
    np.testing.assert_allclose(out, a @ b.transpose(0, 2, 1), rtol=1e-4)
    check(want, out)
    c = _rand(2, 3, 3)
    want, out = both(lambda p: p.nd.linalg_gemm(
        p.nd.array(a), p.nd.array(b), p.nd.array(c), transpose_b=True,
        alpha=2.0, beta=0.5))
    np.testing.assert_allclose(out, 2.0 * (a @ b.transpose(0, 2, 1))
                               + 0.5 * c, rtol=1e-4)
    check(want, out)
    low = np.linalg.cholesky(_spd(2, 3))
    x = _rand(2, 3, 4)
    want, y = both(lambda p: p.nd.linalg_trmm(p.nd.array(low),
                                              p.nd.array(x)))
    np.testing.assert_allclose(y, low @ x, rtol=1e-4)
    check(want, y)
    want, back = both(lambda p: p.nd.linalg_trsm(p.nd.array(low),
                                                 p.nd.array(y)))
    np.testing.assert_allclose(back, x, rtol=1e-3, atol=1e-4)
    check(want, back)


def test_linalg_syrk_syevd():
    a = _rand(2, 3, 4)
    want, out = both(lambda p: p.nd.linalg_syrk(p.nd.array(a), alpha=1.0))
    np.testing.assert_allclose(out, a @ a.transpose(0, 2, 1), rtol=1e-4)
    check(want, out)
    spd = _spd(1, 4)
    want, (u, lam) = both(lambda p: p.nd.linalg_syevd(p.nd.array(spd)))
    rec = u.transpose(0, 2, 1) @ (lam[:, :, None] * u)
    np.testing.assert_allclose(rec, spd, rtol=1e-2, atol=1e-2)
    check(canonical_signs("syevd", want), canonical_signs("syevd", [u, lam]),
          rtol=1e-4, atol=1e-5)


def test_nd_linalg_namespace_and_gelqf():
    """``nd.linalg`` holds the ten ops under their short names; gelqf's
    L Q reconstructs the input, L lower and Q's rows orthonormal, equal
    to the JAX package's up to sign."""
    a = _rand(2, 3, 5)
    assert sorted(n for n in mt.nd.linalg.__all__) == sorted(
        mx.nd.linalg.__all__)
    want, (lo, q) = both(lambda p: p.nd.linalg.gelqf(p.nd.array(a)))
    np.testing.assert_allclose(lo @ q, a, rtol=1e-5, atol=1e-5)
    assert (np.triu(lo[0], 1) == 0).all()
    np.testing.assert_allclose(q @ q.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), (2, 3, 3)),
                               atol=1e-5)
    check(canonical_signs("gelqf", want), canonical_signs("gelqf", [lo, q]))


def test_fft_ifft_roundtrip():
    x = _rand(3, 8)
    want, f = both(lambda p: p.nd.contrib.fft(p.nd.array(x)))
    assert f.shape == (3, 16)
    check(want, f)
    want, back = both(lambda p: p.nd.contrib.ifft(p.nd.array(f)))
    np.testing.assert_allclose(back, x * 8, rtol=1e-4, atol=1e-4)
    check(want, back)


def test_quantize_dequantize_roundtrip():
    x = _rand(4, 5)

    def run(p):
        q, qmin, qmax = p.nd.contrib.quantize(
            p.nd.array(x), p.nd.array(np.array([0.0], np.float32)),
            p.nd.array(np.array([1.0], np.float32)), out_type="uint8")
        return [q, p.nd.contrib.dequantize(q, qmin, qmax,
                                           out_type="float32")]
    want, (q, deq) = both(run)
    assert q.dtype == np.uint8
    np.testing.assert_allclose(deq, x, atol=1.0 / 255 + 1e-4)
    check(want, [q, deq], rtol=0, atol=0)


def test_count_sketch_preserves_inner_products():
    x = _rand(4, 32)
    h = np.random.RandomState(0).randint(0, 16, (1, 32)).astype(np.float32)
    s = (np.random.RandomState(1).randint(0, 2, (1, 32)) * 2 - 1).astype(
        np.float32)

    def run(p):
        return p.nd.contrib.count_sketch(p.nd.array(x), p.nd.array(h),
                                         p.nd.array(s), out_dim=16)
    want, out1 = both(run)
    _, out2 = both(run)
    assert out1.shape == (4, 16)
    np.testing.assert_allclose(out1, out2)
    np.testing.assert_allclose((out1 ** 2).sum(), (x ** 2).sum(), rtol=0.5)
    check(want, out1)


def test_bilinear_sampler_identity_grid():
    x = np.random.RandomState(0).randn(1, 2, 4, 4).astype(np.float32)
    ys, xs = np.meshgrid(np.linspace(-1, 1, 4), np.linspace(-1, 1, 4),
                         indexing="ij")
    grid = np.stack([xs, ys])[None].astype(np.float32)
    want, out = both(lambda p: p.nd.BilinearSampler(p.nd.array(x),
                                                    p.nd.array(grid)))
    np.testing.assert_allclose(out, x, atol=1e-5)
    check(want, out)


def test_ctc_loss():
    """``tests/test_gluon.py::test_ctc_loss`` (uniform activations over 5
    labels and a blank at 0, T=10, layout NTC), then the TNC layout with
    a batch-second label on other activations; the port's losses equal
    the JAX package's."""
    T, N, C = 10, 2, 6
    label = np.array([[1, 2, 0, 0], [1, 2, 3, 0]], np.float32)
    want, out = both(lambda p: p.gluon.loss.CTCLoss(layout="NTC")(
        p.nd.zeros((N, T, C)), p.nd.array(label)))
    assert out.shape == (N,)
    assert np.all(np.isfinite(out)) and np.all(out > 0)
    check(want, out)
    pred = np.random.RandomState(3).randn(T, N, C).astype(np.float32)
    want, out = both(lambda p: p.gluon.loss.CTCLoss(
        layout="TNC", label_layout="TN")(p.nd.array(pred),
                                         p.nd.array(label.T.copy())))
    check(want, out)


def test_torch_bridge_roundtrip():
    x0 = np.random.RandomState(5).randn(3, 4).astype(np.float32)
    with mt.cpu():
        x = mt.nd.array(x0)
        t = mt.torch.to_torch(x)
        assert torch.is_tensor(t)
        t.add_(1.0)   # a copy: the array keeps its values
        np.testing.assert_array_equal(x.asnumpy(), x0)
        back = mt.torch.from_torch(t)
        np.testing.assert_allclose(back.asnumpy(), x0 + 1.0)
        relu = mt.torch.pytorch_fn(torch.nn.functional.relu)
        y = relu(x)
    with mx.cpu():
        want = mx.torch.pytorch_fn(torch.nn.functional.relu)(
            mx.nd.array(x0)).asnumpy()
    np.testing.assert_allclose(y.asnumpy(), np.maximum(x0, 0))
    np.testing.assert_array_equal(y.asnumpy(), want)


def test_bridge_module_shadows_no_torch():
    """``mt.torch`` is the bridge, and the package's modules still reach
    PyTorch itself under the name ``torch``."""
    import mxnet_tpu_torch.ops.nn as port_nn
    from mxnet_tpu_torch import torch as bridge
    assert bridge.__name__ == "mxnet_tpu_torch.torch_bridge"
    assert port_nn.torch is torch and mt.ops.registry.torch is torch
    assert bridge.torch is torch
