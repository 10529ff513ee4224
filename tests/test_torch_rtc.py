"""User-kernel registration of the PyTorch package against the JAX package.

The port of ``tests/test_pallas_register.py``, case for case (the
``Module`` case waits for ``Module``): ``pl_scale`` is registered in both
packages, in JAX as the Pallas kernel (interpret mode on the CPU) and in
the port over ``ops.scale`` (its plain version on the CPU).  The CUDA
kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx
from mxnet_tpu import ndarray as jnd
from mxnet_tpu import symbol as jsym

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd, sym, rtc
from mxnet_tpu_torch.ops import scale as sc
from mxnet_tpu_torch.ops.registry import OP_REGISTRY


def _scale_grad(og, ins, outs, attrs):
    return (og[0] * float(attrs.get("alpha", 2.0)),)


def _register_scale(name="pl_scale", **kw):
    """The port's ``pl_scale``: the kernel, or its plain body when the
    registry fills ``interpret=True``."""
    def pl_scale(x, alpha=2.0, interpret=False):
        return sc.scale_reference(x, alpha) if interpret else sc.scale(x, alpha)
    return rtc.register(name, pl_scale, grad=_scale_grad, **kw)


def _scale_body(x_ref, o_ref, *, alpha):
    o_ref[...] = x_ref[...] * alpha


def _register_jax_scale(name="pl_scale"):
    from jax.experimental import pallas as pl

    def pl_scale(x, alpha=2.0, interpret=False):
        return pl.pallas_call(
            functools.partial(_scale_body, alpha=float(alpha)),
            out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=bool(interpret))(x)
    return mx.pallas.register(name, pl_scale, grad=_scale_grad)


@pytest.fixture
def _cleanup():
    before = set(rtc.registered_kernels()), set(mx.pallas.registered_kernels())
    yield
    for name in rtc.registered_kernels():
        if name not in before[0]:
            rtc.unregister(name)
    for name in mx.pallas.registered_kernels():
        if name not in before[1]:
            mx.pallas.unregister(name)


def _x():
    return np.arange(6.0, dtype=np.float32).reshape(2, 3)


def test_eager_and_symbolic_invocation(_cleanup):
    fn = _register_scale()
    jfn = _register_jax_scale()
    x = nd.array(_x(), ctx=mt.cpu())
    want = jfn(jnd.array(_x()), alpha=3.0).asnumpy()
    np.testing.assert_array_equal(fn(x, alpha=3.0).asnumpy(), want)
    # exposed on the nd namespace like a built-in
    np.testing.assert_array_equal(nd.pl_scale(x, alpha=3.0).asnumpy(), want)
    # symbolic: bind + forward
    s = sym.pl_scale(sym.Variable("d"), alpha=4.0)
    ex = s.simple_bind(mt.cpu(), grad_req="write", d=(2, 3))
    ex.arg_dict["d"][:] = _x()
    js = jsym.pl_scale(jsym.Variable("d"), alpha=4.0)
    jex = js.simple_bind(mx.cpu(), grad_req="write", d=(2, 3))
    jex.arg_dict["d"][:] = _x()
    np.testing.assert_array_equal(ex.forward()[0].asnumpy(),
                                  jex.forward()[0].asnumpy())


def test_semantic_grad_through_executor(_cleanup):
    _register_scale()
    _register_jax_scale()
    s = sym.sum(sym.pl_scale(sym.Variable("d"), alpha=5.0))
    ex = s.simple_bind(mt.cpu(), grad_req="write", d=(2, 3))
    ex.arg_dict["d"][:] = 1.0
    ex.forward(is_train=True)
    ex.backward()
    np.testing.assert_allclose(ex.grad_dict["d"].asnumpy(),
                               np.full((2, 3), 5.0))
    js = jsym.sum(jsym.pl_scale(jsym.Variable("d"), alpha=5.0))
    jex = js.simple_bind(mx.cpu(), grad_req="write", d=(2, 3))
    jex.arg_dict["d"][:] = 1.0
    jex.forward(is_train=True)
    jex.backward()
    np.testing.assert_array_equal(ex.grad_dict["d"].asnumpy(),
                                  jex.grad_dict["d"].asnumpy())


def test_autograd_through_pure_torch_body(_cleanup):
    # a pure-PyTorch body needs no grad=: torch's autograd differentiates it
    rtc.register("pl_cube", lambda x: x ** 3)
    with mt.cpu():
        x = nd.array(np.array([1.0, 2.0]))
        x.attach_grad()
        with mt.autograd.record():
            y = nd.pl_cube(x)
        y.backward(nd.array(np.ones(2)))
    np.testing.assert_allclose(x.grad.asnumpy(), 3 * x.asnumpy() ** 2)


def test_duplicate_name_rejected(_cleanup):
    _register_scale()
    with pytest.raises(mt.MXNetError):
        _register_scale()
    _register_scale(force=True)  # explicit replacement allowed
    assert rtc.registered_kernels().count("pl_scale") == 1


def test_unregister_removes_wrappers(_cleanup):
    _register_scale("pl_gone")
    assert hasattr(nd, "pl_gone") and hasattr(sym, "pl_gone")
    assert hasattr(nd._internal, "pl_gone")
    rtc.unregister("pl_gone")
    assert not hasattr(nd, "pl_gone")
    assert not hasattr(sym, "pl_gone")
    assert not hasattr(sym._internal, "pl_gone")
    with pytest.raises(mt.MXNetError):
        rtc.unregister("pl_gone")


def test_builtin_protected_from_unregister():
    with pytest.raises(mt.MXNetError):
        rtc.unregister("FullyConnected")
    assert "FullyConnected" in OP_REGISTRY


def test_force_over_builtin_restored_on_unregister():
    """force=True over a built-in stashes the original op and restores it
    (registry and nd/sym wrappers) on unregister, also after two forced
    registrations."""
    original = OP_REGISTRY["relu"]
    x = nd.array(np.array([-1.0, 2.0], np.float32), ctx=mt.cpu())

    def fake_relu(a):
        return a * 0.0 + 7.0

    try:
        rtc.register("relu", fake_relu, force=True)
        assert np.allclose(nd.relu(x).asnumpy(), 7.0)
    finally:
        rtc.unregister("relu")
    assert OP_REGISTRY["relu"] is original
    assert np.allclose(nd.relu(x).asnumpy(), [0.0, 2.0])
    try:
        rtc.register("relu", fake_relu, force=True)
        rtc.register("relu", fake_relu, force=True)
    finally:
        rtc.unregister("relu")
    assert OP_REGISTRY["relu"] is original
    assert np.allclose(nd.relu(x).asnumpy(), [0.0, 2.0])
    assert OP_REGISTRY["relu"].fn is not fake_relu


@pytest.mark.parametrize("shape,alpha", [((2, 3), 0.5), ((8, 128), 3.0),
                                         ((7,), -1.25), ((64, 128), 0.5),
                                         ((64, 128), 0.1), ((1000,), 1 / 3)])
def test_scale_reference_bitwise_equal_to_jax_interpret(_cleanup, shape,
                                                        alpha):
    jfn = _register_jax_scale()
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    want = jfn(jnd.array(x), alpha=alpha).asnumpy()
    got = sc.scale_reference(torch.from_numpy(x), alpha).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, want)
    # one rounding of alpha to fp32, then one fp32 multiply: what the
    # kernel does with the C float it is given
    np.testing.assert_array_equal(got, x * np.float32(alpha))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_scale_reference_rounds_once(dtype):
    x = torch.from_numpy(np.random.RandomState(3).randn(100).astype(
        np.float32)).to(dtype)
    got = sc.scale_reference(x, 3.0)
    assert got.dtype == dtype
    assert torch.equal(got, (x.double() * 3.0).float().to(dtype))


def test_cpu_and_meta_run_the_plain_version():
    sc.reset_launch_count()
    x = torch.ones(4, 5)
    assert torch.equal(sc.scale(x, 2.0), torch.full((4, 5), 2.0))
    meta = sc.scale(x.to("meta"), 2.0)
    assert meta.device.type == "meta" and meta.shape == (4, 5)
    assert sc.launch_count() == 0


def test_raw_body_without_grad_raises_when_recorded(_cleanup):
    def opaque(x):  # leaves autograd, as a kernel launched by hand does
        return torch.from_numpy(x.detach().numpy() * 2.0)

    rtc.register("pl_opaque", opaque)
    x = nd.array(_x(), ctx=mt.cpu())
    np.testing.assert_array_equal(nd.pl_opaque(x).asnumpy(), _x() * 2.0)
    x.attach_grad()
    with pytest.raises(mt.MXNetError, match="grad="):
        with mt.autograd.record():
            nd.pl_opaque(x)
    # bound symbolically, the training forward refuses it too
    ex = sym.sum(sym.pl_opaque(sym.Variable("d"))).bind(
        mt.cpu(), {"d": nd.array(_x(), ctx=mt.cpu())})
    ex.forward(is_train=False)
    with pytest.raises(mt.MXNetError, match="grad="):
        ex.forward(is_train=True)


def test_shape_inference_without_plain_body_raises(_cleanup):
    def kernel_only(x, alpha=2.0):
        return sc.scale(x, alpha)

    rtc.register("pl_kernel_only", kernel_only, grad=_scale_grad)
    s = sym.pl_kernel_only(sym.Variable("d"))
    with pytest.raises(mt.MXNetError, match="no plain body"):
        s.infer_shape(d=(2, 3))
    with pytest.raises(mt.MXNetError, match="no plain body"):
        s.simple_bind(mt.cpu(), d=(2, 3))


def test_interpret_pinned(_cleanup):
    _register_scale()
    x = nd.array(_x(), ctx=mt.cpu())
    # pinned True on the CPU: the plain body, as the default picks there
    np.testing.assert_array_equal(
        nd.pl_scale(x, alpha=2.0, interpret=True).asnumpy(), _x() * 2.0)
    # pinned False asks for the kernel, which needs CUDA tensors
    with pytest.raises(mt.MXNetError, match="interpret=False"):
        nd.pl_scale(x, alpha=2.0, interpret=False)
    _register_scale("pl_scale_kernel", interpret=False)
    with pytest.raises(mt.MXNetError, match="interpret=False"):
        nd.pl_scale_kernel(x)
