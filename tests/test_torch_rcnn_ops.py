"""The R-CNN ops against the JAX package on the CPU.

``tests/test_rcnn_ops.py`` case for case: ``Proposal`` and
``MultiProposal`` (batch indices, clipping, the two equal),
``PSROIPooling``'s position sensitivity, ``DeformablePSROIPooling`` with
``no_trans`` equal to ``PSROIPooling``, and deformable convolution at
zero, integer and grouped offsets against a plain convolution
(``F.conv2d`` here, ``lax.conv_general_dilated`` there).  Each case runs
in both packages and holds the reference's own assertion for the port;
the port's outputs equal the JAX package's within 1e-6 relative (the
same fp32 formulas; deformable convolution's products summed in other
orders, 1e-5).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax import lax
import mxnet_tpu as mx
from mxnet_tpu.ops.rcnn import _deform_conv_one

import mxnet_tpu_torch as mt

PARITY = dict(rtol=1e-6, atol=1e-6)
CONV_PARITY = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    prev = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_enable_x64", prev[0])
    torch.set_num_threads(prev[1])


def both(fn):
    with mx.cpu():
        want = fn(mx).asnumpy()
    with mt.cpu():
        got = fn(mt).asnumpy()
    assert got.shape == want.shape
    return want, got


def _proposal_inputs(seed, n, a, h, w):
    rng = np.random.RandomState(seed)
    cls = rng.rand(n, 2 * a, h, w).astype("float32")
    bbox = (rng.randn(n, 4 * a, h, w) * 0.1).astype("float32")
    return cls, bbox


def test_proposal_shapes_and_validity():
    cls, bbox = _proposal_inputs(0, 2, 3, 4, 4)
    info = np.array([[64, 64, 1.0], [64, 64, 1.0]], "float32")
    want, r = both(lambda p: p.nd.contrib.Proposal(
        p.nd.array(cls), p.nd.array(bbox), p.nd.array(info),
        rpn_pre_nms_top_n=20, rpn_post_nms_top_n=6, feature_stride=16,
        scales=(8,), ratios=(0.5, 1, 2)))
    np.testing.assert_allclose(r, want, **PARITY)
    assert r.shape == (2 * 6, 5)
    assert set(r[:6, 0]) <= {0.0} and set(r[6:, 0]) <= {1.0}
    assert r[:, 1:].min() >= 0.0 and r[:, 1:].max() <= 63.0


def test_multi_proposal_matches_proposal():
    cls, bbox = _proposal_inputs(1, 1, 3, 3, 3)
    bbox *= 0.5
    info = np.array([[48, 48, 1.0]], "float32")
    kw = dict(rpn_pre_nms_top_n=10, rpn_post_nms_top_n=4, feature_stride=16,
              scales=(8,), ratios=(0.5, 1, 2))
    want, a = both(lambda p: p.nd.contrib.Proposal(
        p.nd.array(cls), p.nd.array(bbox), p.nd.array(info), **kw))
    _, b = both(lambda p: p.nd.contrib.MultiProposal(
        p.nd.array(cls), p.nd.array(bbox), p.nd.array(info), **kw))
    np.testing.assert_allclose(a, b)
    np.testing.assert_allclose(a, want, **PARITY)


def test_psroi_pooling_position_sensitivity():
    data = np.zeros((1, 4, 8, 8), np.float32)
    for c in range(4):
        data[0, c] = c + 1
    rois = np.array([[0, 0, 0, 31, 31]], np.float32)
    want, out = both(lambda p: p.nd.contrib.PSROIPooling(
        p.nd.array(data), p.nd.array(rois), spatial_scale=0.25,
        output_dim=1, pooled_size=2, group_size=2))
    np.testing.assert_allclose(out[0, 0], [[1.0, 2.0], [3.0, 4.0]],
                               atol=1e-5)
    np.testing.assert_allclose(out, want, **PARITY)


def _port_deform(img, offs, wgt, **kw):
    """The port's op on one image: (Cout, Ho, Wo)."""
    with mt.cpu():
        out = mt.nd.contrib.DeformableConvolution(
            mt.nd.array(img[None]), mt.nd.array(offs[None]),
            mt.nd.array(wgt), kernel=wgt.shape[2:], num_filter=wgt.shape[0],
            no_bias=True, **kw)
    return out.asnumpy()[0]


def test_deformable_conv_zero_offset_equals_conv():
    rng = np.random.RandomState(2)
    img = rng.rand(3, 6, 6).astype(np.float32)
    wgt = rng.rand(4, 3, 3, 3).astype(np.float32)
    offs = np.zeros((2 * 9, 4, 4), np.float32)
    got = _port_deform(img, offs, wgt)
    ref = F.conv2d(torch.tensor(img[None]), torch.tensor(wgt))[0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    want = _deform_conv_one(jnp.asarray(img), jnp.asarray(offs),
                            jnp.asarray(wgt), None, (3, 3), (1, 1), (0, 0),
                            (1, 1), 1)
    np.testing.assert_allclose(got, np.asarray(want), **CONV_PARITY)


def test_deformable_conv_op_with_shift():
    """Integer offset (0, 1) equals convolving the x-shifted image."""
    rng = np.random.RandomState(3)
    img = rng.rand(1, 7, 7).astype(np.float32)
    wgt = rng.rand(2, 1, 3, 3).astype(np.float32)
    offs = np.zeros((2 * 9, 5, 5), np.float32)
    offs[1::2] = 1.0
    got = _port_deform(img, offs, wgt)
    shifted = np.zeros_like(img)
    shifted[:, :, :-1] = img[:, :, 1:]
    ref = F.conv2d(torch.tensor(shifted[None]), torch.tensor(wgt))[0].numpy()
    np.testing.assert_allclose(got[:, :, :-1], ref[:, :, :-1], atol=1e-4)
    want = _deform_conv_one(jnp.asarray(img), jnp.asarray(offs),
                            jnp.asarray(wgt), None, (3, 3), (1, 1), (0, 0),
                            (1, 1), 1)
    np.testing.assert_allclose(got, np.asarray(want), **CONV_PARITY)


def test_deformable_psroi_no_trans_matches_psroi():
    data = np.random.RandomState(4).rand(1, 8, 8, 8).astype(np.float32)
    rois = np.array([[0, 0, 0, 28, 28]], np.float32)
    kw = dict(spatial_scale=0.25, output_dim=2, pooled_size=2, group_size=2)
    _, a = both(lambda p: p.nd.contrib.PSROIPooling(
        p.nd.array(data), p.nd.array(rois), **kw))
    want, b = both(lambda p: p.nd.contrib.DeformablePSROIPooling(
        p.nd.array(data), p.nd.array(rois), no_trans=True, **kw))
    np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(b, want, **PARITY)


def test_deformable_conv_grouped():
    """num_group > 1 contracts each output group against its input
    slice."""
    rng = np.random.RandomState(5)
    img = rng.rand(4, 6, 6).astype(np.float32)
    wgt = rng.rand(4, 2, 3, 3).astype(np.float32)
    offs = np.zeros((2 * 9, 4, 4), np.float32)
    got = _port_deform(img, offs, wgt, num_group=2)
    ref = F.conv2d(torch.tensor(img[None]), torch.tensor(wgt),
                   groups=2)[0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    want = lax.conv_general_dilated(jnp.asarray(img)[None],
                                    jnp.asarray(wgt), (1, 1), "VALID",
                                    feature_group_count=2)[0]
    np.testing.assert_allclose(got, np.asarray(want), **CONV_PARITY)
