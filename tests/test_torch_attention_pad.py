"""Head dims outside the kernels' widths in the PyTorch package's flash attention.

The CUDA kernels take D in ``HEAD_DIMS`` (16, 32, 64, 128); the JAX
package's kernel takes any D.  On the card the wrappers run any other D up
to 128 at the next kernel width (``attention.at_kernel_width``): q, k, v
(and the output gradient) zero-padded along D, the scale of the true D,
the results sliced back.  Here, on the CPU, that planning is driven with
the plain versions in place of the kernels and held against the JAX
package's ``flash_attention`` (the Pallas kernel in interpret mode) and its
gradient, at the tolerances of ``tests/test_torch_attention.py`` and
``tests/test_torch_attention_grad.py``.  The kernels themselves at a padded
D (48) are checked on the card by ``chip_smoke.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import attention as att

# fp32 on the CPU: both sides sum in fp32 in other orders
ATOL = 2e-5
GRAD_ATOL = 1e-4

PAD_CASES = [  # (shape, causal, sm_scale, jax block size)
    ((2, 2, 48, 4), True, None, 16),      # the repo's SMALL LM: D 4
    ((1, 3, 40, 24), False, None, 8),
    ((1, 2, 48, 48), True, None, 16),
    ((1, 2, 32, 96), True, 0.5, 16),      # d_model 768 over 8 heads
    ((2, 1, 40, 96), False, None, 8),
]


def _inputs(shape, seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _spy(fn, seen):
    def call(*args):
        seen.append(args)
        return fn(*args)
    return call


@pytest.mark.parametrize("head_dim,width", [
    (1, 16), (4, 16), (16, 16), (17, 32), (24, 32), (32, 32), (33, 64),
    (48, 64), (64, 64), (65, 128), (96, 128), (128, 128)])
def test_kernel_width(head_dim, width):
    assert att.kernel_width(head_dim) == width
    assert att.design(torch.bfloat16, head_dim) == "wgmma+tma"
    assert att.design(torch.float32, head_dim) == "wgmma+bf16x3"


@pytest.mark.parametrize("head_dim", [129, 160, 256])
def test_head_dim_above_128_refused(head_dim):
    with pytest.raises(MXNetError, match="above 128"):
        att.kernel_width(head_dim)
    assert att.design(torch.float32, head_dim) is None
    q = torch.zeros(1, 1, 8, head_dim)
    with pytest.raises(MXNetError):
        att.at_kernel_width(lambda *a: a[0], (q, q, q), None)


@pytest.mark.parametrize("shape,causal,sm_scale,block", PAD_CASES)
def test_padded_forward_matches_jax(shape, causal, sm_scale, block):
    q, k, v = _inputs(shape, seed=sum(shape))
    seen = []
    plain = _spy(lambda q, k, v, scale: att.flash_attention_reference(
        q, k, v, causal, scale), seen)
    out = att.at_kernel_width(plain, tuple(map(torch.from_numpy, (q, k, v))),
                              sm_scale)
    width = att.kernel_width(shape[-1])
    (pq, pk_, pv, scale), = seen
    assert all(t.shape[-1] == width and t.is_contiguous()
               for t in (pq, pk_, pv))
    assert scale == (sm_scale or 1.0 / np.sqrt(shape[-1]))
    assert torch.all(pq[..., shape[-1]:] == 0)
    assert tuple(out.shape) == shape
    ref = np.asarray(pk.flash_attention(*map(jnp.asarray, (q, k, v)), causal,
                                        sm_scale, block, block, True))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,causal,sm_scale,block", PAD_CASES)
def test_padded_grads_match_jax(shape, causal, sm_scale, block):
    q, k, v, do = _inputs(shape, seed=sum(shape) + 1, n=4)
    seen = []
    plain = _spy(lambda q, k, v, do, scale: att.chunked_attention_grads(
        q, k, v, do, causal, scale), seen)
    got = att.at_kernel_width(plain,
                              tuple(map(torch.from_numpy, (q, k, v, do))),
                              sm_scale)
    assert all(t.shape[-1] == att.kernel_width(shape[-1])
               for t in seen[0][:4])
    _, vjp = jax.vjp(lambda a, b, c: pk.flash_attention(
        a, b, c, causal, sm_scale, block, block, True),
        *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("head_dim", att.HEAD_DIMS)
def test_kernel_widths_pass_through_uncopied(head_dim):
    """At D 16, 32, 64 and 128 the tensors reach the kernel as they are
    (the model's einsum views stay uncopied), with the scale 1/sqrt(D)."""
    x = torch.randn(2, 24, 3, head_dim)
    q = x.transpose(1, 2)
    seen = []
    out = att.at_kernel_width(_spy(lambda q, k, v, s: q, seen), (q, q, q),
                              None)
    assert out is q
    assert all(t is q for t in seen[0][:3])
    assert seen[0][3] == 1.0 / np.sqrt(head_dim)
