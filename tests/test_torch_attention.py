"""Flash-attention forward of the PyTorch package against the JAX package.

On the CPU the port's ``flash_attention`` runs its plain version; it is held
against the JAX Pallas kernel in interpret mode and against the JAX exact
reference ``local_attention``, on the same numpy inputs.  The CUDA kernel
itself is checked against the plain version on the card by
``chip_smoke.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.parallel.ring_attention import local_attention

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import attention as att

# fp32 on the CPU: both sides sum in fp32 in other orders
ATOL = 2e-5

CASES = [  # (shape, causal, sm_scale, jax block size)
    ((2, 3, 64, 16), False, None, 32),
    ((2, 3, 64, 16), True, None, 32),
    ((1, 2, 48, 16), True, None, 32),     # S not a multiple of the block
    ((1, 2, 48, 16), False, None, 32),
    ((1, 1, 16, 16), False, 0.5, 16),
    ((1, 2, 40, 64), True, 0.5, 16),
]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape,causal,sm_scale,block", CASES)
def test_flash_attention_matches_jax(shape, causal, sm_scale, block):
    q, k, v = _inputs(shape, seed=sum(shape))
    out = att.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, sm_scale=sm_scale).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(pk.flash_attention(jq, jk, jv, causal, sm_scale,
                                           block, block, True))
    exact = np.asarray(local_attention(jq, jk, jv, causal=causal,
                                       sm_scale=sm_scale))
    assert out.shape == shape and out.dtype == np.float32
    np.testing.assert_allclose(out, pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(out, exact, rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_plain_version_keeps_input_dtype(dtype):
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _inputs((1, 2, 24, 16), seed=3))
    out = att.flash_attention(q, k, v, causal=True)
    ref = att.flash_attention_reference(q.float(), k.float(), v.float(),
                                        causal=True)
    assert out.dtype == dtype
    # one rounding of the same fp32 value to the output type
    torch.testing.assert_close(out.float(), ref.to(dtype).float(),
                               rtol=0, atol=2e-2)


def test_cpu_path_launches_no_kernel():
    att.reset_launch_count()
    q, k, v = map(torch.from_numpy, _inputs((1, 1, 8, 16), seed=4))
    att.flash_attention(q, k, v, causal=True)
    assert att.launch_count() == 0


@pytest.mark.parametrize("bad", ["meta", "mixed"])
def test_wrapper_refuses_unsupported_placement(bad):
    q, k, v = map(torch.from_numpy, _inputs((1, 1, 8, 16), seed=5))
    if bad == "meta":
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    else:
        k = k.to("meta")
    with pytest.raises(MXNetError):
        att.flash_attention(q, k, v)
