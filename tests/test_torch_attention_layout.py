"""Strided q, k, v in the PyTorch package's flash attention.

The kernels read q, k and v through their strides, so the transformer's
``einsum("bsd,dhk->bhsk")`` views reach them uncopied.  Here, on the CPU:
the layout check that the CUDA path applies (``check_layout``), the plain
version on strided views against the JAX Pallas kernel in interpret mode
and against ``local_attention``, and the model handing its einsum views to
``flash_attention`` as they are.  The kernels themselves are checked on
strided views on the card by ``chip_smoke.py``.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.models import transformer as jt
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.parallel.ring_attention import local_attention

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.ops import attention as att

# fp32 on the CPU: both sides sum in fp32 in other orders
ATOL = 2e-5
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _einsum_views(b, s, h, d, dtype, seed=0):
    """q, k, v as the transformer makes them: einsum views [B, H, S, D]
    with strides (S*H*D, D, H*D, 1), of unit variance like the kernel
    tests' inputs."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, s, 2 * d).astype(np.float32)).to(dtype)
    w = [rng.randn(2 * d, h, d).astype(np.float32) / np.sqrt(2 * d)
         for _ in range(3)]
    return [torch.einsum("bsd,dhk->bhsk", x, torch.from_numpy(a).to(dtype))
            for a in w]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["contiguous", "einsum"])
def test_check_layout_accepts(dtype, layout):
    b, s, h, d = 2, 24, 3, 16
    if layout == "contiguous":
        qkv = [torch.randn(b, h, s, d).to(dtype) for _ in range(3)]
        assert all(t.is_contiguous() for t in qkv)
    else:
        qkv = _einsum_views(b, s, h, d, dtype)
        assert qkv[0].stride() == (s * h * d, d, h * d, 1)
        assert not qkv[0].is_contiguous()
    att.check_layout(*qkv)


def _misaligned(shape, dtype):
    n = int(np.prod(shape))
    return torch.randn(n + 1).to(dtype)[1:].view(shape)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fault", ["last_stride", "stride_bytes", "offset"])
def test_check_layout_refuses(dtype, fault):
    good = torch.randn(1, 2, 32, 32).to(dtype)
    if fault == "last_stride":
        bad = good.transpose(2, 3)            # S = D: same shape, stride 32
        assert bad.shape == good.shape and bad.stride(-1) != 1
    elif fault == "stride_bytes":
        bad = torch.randn(1, 2, 32, 33).to(dtype)[..., :32]  # 33 elements
        assert (bad.stride(2) * bad.element_size()) % 16
    else:
        bad = _misaligned(good.shape, dtype)  # one element off
        assert bad.data_ptr() % 16
    with pytest.raises(MXNetError):
        att.check_layout(good, good, bad)
    with pytest.raises(MXNetError):
        att.check_layout(bad, good, good)


def test_check_layout_skips_size_one_dims():
    # a dimension of size 1 is never stepped: its stride is not checked
    t = torch.randn(3, 1, 8, 16).as_strided((3, 1, 8, 16), (128, 7, 16, 1))
    att.check_layout(t, t, t)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma+tma"), (torch.float16, 128, "wgmma+tma"),
    (torch.bfloat16, 32, "wgmma+tma"), (torch.float16, 16, "wgmma+tma"),
    (torch.float32, 64, "wgmma+bf16x3"), (torch.float32, 128, "wgmma+bf16x3"),
    (torch.float32, 32, "wgmma+bf16x3"), (torch.float32, 16, "wgmma+bf16x3")])
def test_design_routes_by_dtype_and_head_dim(dtype, d, want):
    assert att.design(dtype, d) == want
    assert att.KERNEL_SOURCES[want].endswith(".cu")


@pytest.mark.parametrize("sources", ["KERNEL_SOURCES", "BACKWARD_SOURCES"])
def test_kernel_sources_define_their_launchers(sources):
    """Each design's source exists and defines the C launcher the wrapper
    looks up by the file's stem, with the argument list of its kind."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for src in getattr(att, sources).values():
        stem = os.path.splitext(os.path.basename(src))[0]
        with open(os.path.join(repo, src)) as f:
            text = " ".join(f.read().split())
        assert 'extern "C" int %s(const void* q, const void* k, ' \
            'const void* v, ' % stem in text, src


STRIDED_CASES = [  # (b, s, h, d, causal, sm_scale, jax block size)
    (2, 64, 3, 16, False, None, 32),
    (2, 64, 3, 16, True, None, 32),
    (1, 48, 2, 16, True, None, 32),
    (1, 40, 2, 64, True, 0.5, 16),
    (1, 33, 2, 32, False, None, 16),
]


@pytest.mark.parametrize("b,s,h,d,causal,sm_scale,block", STRIDED_CASES)
def test_strided_views_match_jax(b, s, h, d, causal, sm_scale, block):
    q, k, v = _einsum_views(b, s, h, d, torch.float32, seed=s + d)
    # (at b = 1 torch may give the batch dimension any stride)
    assert q.stride()[1:] == (d, h * d, 1) and not q.is_contiguous()
    att.reset_launch_count()
    out = att.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    assert att.launch_count() == 0
    assert out.is_contiguous() and out.shape == (b, h, s, d)
    jq, jk, jv = (jnp.asarray(t.contiguous().numpy()) for t in (q, k, v))
    pallas = np.asarray(pk.flash_attention(jq, jk, jv, causal, sm_scale,
                                           block, block, True))
    exact = np.asarray(local_attention(jq, jk, jv, causal=causal,
                                       sm_scale=sm_scale))
    np.testing.assert_allclose(out.numpy(), pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), exact, rtol=0, atol=ATOL)
    # the same values contiguous give the same output
    same = att.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, sm_scale=sm_scale)
    assert torch.equal(out, same)


def test_transformer_hands_einsum_views_uncopied(monkeypatch):
    small = dict(vocab=32, d_model=16, n_heads=4, d_ff=32, n_layers=2,
                 max_len=128)
    jcfg = jt.TransformerLMConfig(**small)
    tcfg = tt.TransformerLMConfig(**small)
    np_params = {n: np.asarray(a) for n, a in jt.init_transformer_params(
        jax.random.PRNGKey(0), jcfg).items()}
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, jcfg.vocab, (2, 24)).astype(np.int32)

    made, seen = [], []
    einsum = torch.einsum

    def spy_einsum(eq, *args):
        out = einsum(eq, *args)
        if eq == "bsd,dhk->bhsk":
            made.append(out)
        return out

    def spy_flash(q, k, v, causal=False, sm_scale=None):
        seen.append((q, k, v))
        return att.flash_attention(q, k, v, causal, sm_scale)

    monkeypatch.setattr(torch, "einsum", spy_einsum)
    monkeypatch.setattr(tt, "flash_attention", spy_flash)
    params = tt.params_from_jax(np_params, tcfg, device="cpu")
    with torch.no_grad():
        logits = tt.transformer_forward(params, torch.from_numpy(tokens), tcfg)
    assert len(seen) == tcfg.n_layers and len(made) == 3 * tcfg.n_layers
    b, s, h, hd = 2, 24, 4, 4
    for layer, qkv in enumerate(seen):
        for got, want in zip(qkv, made[3 * layer:3 * layer + 3]):
            assert got is want
            assert got.data_ptr() == want.data_ptr()
            assert got.stride() == (s * h * hd, hd, h * hd, 1)
    ref = np.asarray(jt.transformer_forward(
        {n: jnp.asarray(a) for n, a in np_params.items()},
        jnp.asarray(tokens), jcfg))
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0, atol=1e-4)
