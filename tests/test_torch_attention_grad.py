"""Flash-attention gradient of the PyTorch package against the JAX package.

On the CPU the port's ``flash_attention`` is a ``torch.autograd.Function``
whose backward runs ``chunked_attention_grads``, the plain version of the
backward kernels.  Here, on the same numpy inputs: that plain version against the JAX package's
``_chunked_attn_grads`` called directly, autograd through the port's
``flash_attention`` against ``jax.grad`` of the Pallas kernel in interpret
mode (``tests/test_pallas.py``'s gradient case), and gradients through the
model's strided einsum views back to the projection weights.  The kernels
themselves (``flash_attn_bwd_sm90.cu`` for bf16/fp16 and
``flash_attn_bwd_f32_sm90.cu`` for fp32) are held against
``chunked_attention_grads`` on the card by ``chip_smoke.py``; here a CPU model of the 16-bit tensor-core kernel's
roundings is held to the same limits, which pins the tolerance argument
beside ``chip_smoke.BWD_ROW_RTOL`` (the fp32 kernel's split:
``tests/test_torch_attention_split.py``).
"""
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.parallel.ring_attention import local_attention

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.ops import attention as att
from mxnet_tpu_torch.test_utils import (SHARP_ROW_C, attention_grads_fp64,
                                        row_errors, sharp_row_check)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke", "chip_smoke.py")
cpu_model = _load("torch_flash_bwd_cpu_model",
                  "tools/torch_flash_bwd_cpu_model.py")

# fp32 on the CPU, the same recompute in both packages: sums in other orders
ATOL = 1e-5
# through autograd, against the JAX kernel's custom_vjp: tests/test_pallas.py
GRAD_ATOL = 1e-4

CHUNK_CASES = [  # (shape, causal, sm_scale, chunk)
    ((1, 2, 32, 8), True, None, 512),
    ((1, 2, 32, 8), False, None, 512),
    ((2, 3, 48, 16), True, None, 32),      # 48 rows in chunks of 32: padded
    ((2, 3, 48, 16), False, None, 32),
    ((1, 2, 40, 16), True, 0.5, 16),
    ((1, 1, 16, 16), False, 0.5, 512),
]


def _inputs(shape, seed, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("shape,causal,sm_scale,chunk", CHUNK_CASES)
def test_chunked_grads_match_jax(shape, causal, sm_scale, chunk):
    q, k, v, do = _inputs(shape, seed=sum(shape) + chunk)
    got = att.chunked_attention_grads(*map(torch.from_numpy, (q, k, v, do)),
                                      causal=causal, sm_scale=sm_scale,
                                      chunk=chunk)
    ref = pk._chunked_attn_grads(*map(jnp.asarray, (q, k, v, do)), causal,
                                 sm_scale, chunk=chunk)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_grads_bf16_match_jax(causal):
    """bf16 inputs: both widen to fp32, compute, and round once to bf16 at
    the end; the fp32 values differ by summation order only, so the bf16
    results agree to one bf16 ulp (2^-7 of the value) at most."""
    shape = (2, 3, 48, 16)
    q, k, v, do = _inputs(shape, seed=7)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v, do))
    got = att.chunked_attention_grads(tq, tk, tv, tdo, causal=causal,
                                      chunk=32)
    ref = pk._chunked_attn_grads(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
          for t in (tq, tk, tv, tdo)), causal, None, chunk=32)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        r = np.asarray(r).astype(np.float32)
        np.testing.assert_allclose(g.float().numpy(), r, rtol=2.0 ** -7,
                                   atol=ATOL)


@pytest.mark.parametrize("causal,sm_scale", [(True, None), (False, None),
                                             (True, 0.5)])
def test_autograd_matches_jax_grad_of_pallas(causal, sm_scale):
    """``tests/test_pallas.py::test_flash_gradients_match_reference``'s
    case: grads of sum(o^2) through the kernel's custom_vjp (interpret
    mode) and through the port's autograd Function."""
    q, k, v = _inputs((1, 2, 32, 8), seed=2, n=3)

    def loss_pallas(q, k, v):
        return jnp.sum(pk.flash_attention(q, k, v, causal, sm_scale, 16, 16,
                                          True) ** 2)

    ref = jax.grad(loss_pallas, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = att.flash_attention(tq, tk, tv, causal=causal, sm_scale=sm_scale)
    got = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=GRAD_ATOL)


def test_cpu_backward_is_the_plain_version():
    """The CPU path goes through FlashAttention, whose backward is exactly
    chunked_attention_grads (not torch's autograd of the forward)."""
    q, k, v, do = map(torch.from_numpy, _inputs((2, 2, 24, 16), seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = att.flash_attention(*leaves, causal=True, sm_scale=0.5)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, do)
    want = att.chunked_attention_grads(q, k, v, do, causal=True, sm_scale=0.5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_gradients_through_einsum_views_reach_projections():
    """q, k, v as the model makes them (einsum views with strides (S*H*D,
    D, H*D, 1)); gradients of a weighted sum of the attention output back
    to x, wq, wk and wv, against jax.grad of the same function with the
    Pallas kernel in interpret mode."""
    b, s, h, d, dm = 2, 24, 2, 16, 32
    rng = np.random.RandomState(11)
    x = rng.randn(b, s, dm).astype(np.float32)
    ws = [(rng.randn(dm, h, d) / np.sqrt(dm)).astype(np.float32)
          for _ in range(3)]
    w_out = rng.randn(b, h, s, d).astype(np.float32)

    def jax_loss(x, wq, wk, wv):
        q, k, v = (jnp.einsum("bsd,dhk->bhsk", x, w) for w in (wq, wk, wv))
        o = pk.flash_attention(q, k, v, True, None, 8, 8, True)
        return jnp.sum(o * w_out)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, [x] + ws))
    leaves = [torch.from_numpy(a).requires_grad_() for a in [x] + ws]
    q, k, v = (torch.einsum("bsd,dhk->bhsk", leaves[0], w)
               for w in leaves[1:])
    assert q.stride() == (s * h * d, d, h * d, 1)
    o = att.flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad((o * torch.from_numpy(w_out)).sum(), leaves)
    for name, g, r in zip(("x", "wq", "wk", "wv"), got, ref):
        assert g.abs().max() > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=GRAD_ATOL, err_msg=name)


def test_exact_reference_agrees_with_plain_backward():
    """The plain backward against jax.grad of the exact jnp reference
    (``local_attention``), causal, at a sequence length past one chunk."""
    q, k, v, do = _inputs((1, 2, 70, 16), seed=5)
    _, vjp = jax.vjp(lambda a, b_, c: local_attention(a, b_, c, causal=True),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    got = att.chunked_attention_grads(*map(torch.from_numpy, (q, k, v, do)),
                                      causal=True, chunk=32)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=ATOL)


def test_cpu_path_launches_no_kernel():
    att.reset_launch_count()
    att.reset_backward_launch_count()
    q, k, v, do = map(torch.from_numpy, _inputs((1, 2, 16, 16), seed=4))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = att.flash_attention(*leaves, causal=True)
    torch.autograd.grad(out, leaves, do)
    assert att.launch_count() == 0
    assert att.backward_launch_count() == 0


def test_backward_wrapper_refuses_cpu_tensors():
    q, k, v, do = map(torch.from_numpy, _inputs((1, 1, 16, 16), seed=6))
    with pytest.raises(MXNetError):
        att.flash_attention_backward(q, k, v, do, causal=True)


@pytest.mark.parametrize("dtype,head_dim", [(torch.bfloat16, 64),
                                            (torch.float16, 128),
                                            (torch.float32, 64),
                                            (torch.float32, 128),
                                            (torch.float32, 32)])
def test_backward_wrapper_refuses_cpu_tensors_of_each_design(dtype,
                                                             head_dim):
    """Each backward kernel (``design_backward``) takes CUDA tensors only."""
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _inputs((1, 1, 16, head_dim), seed=6))
    with pytest.raises(MXNetError, match="CUDA"):
        att.flash_attention_backward(q, k, v, do, causal=True)


def test_cuda_less_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tt.TransformerLMConfig()
    with pytest.raises(MXNetError):
        tt.make_train_step(cfg)
    with pytest.raises(MXNetError):
        tt.place_batch(np.zeros((1, 4), np.int32), np.zeros((1, 4), np.int32))


@pytest.mark.parametrize("head_dim", att.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_design_backward_mirrors_design(dtype, head_dim):
    """Each backward kernel takes exactly what its forward takes: the
    tensor cores at every head dim (bf16/fp16 as they are, fp32 split
    three ways); every source exists."""
    want = "wgmma+bf16x3" if dtype == torch.float32 else "wgmma+tma"
    assert att.design_backward(dtype, head_dim) == att.design(dtype,
                                                              head_dim)
    assert att.design_backward(dtype, head_dim) == want
    src = att.BACKWARD_SOURCES[want]
    assert os.path.exists(os.path.join(REPO, src)), src


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape,causal,sm_scale", [
    ((2, 4, 200, 64), True, 0.5),    # sharp softmax: ds cancels
    ((1, 3, 130, 128), True, None),
    ((2, 4, 200, 32), True, 0.5),    # the sharp case at D 32 and 16
    ((2, 4, 200, 16), True, 0.5),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tensor_core_rounding_model_within_bwd_limits(dtype, shape, causal,
                                                      sm_scale, seed):
    """Rounding P and dS to bf16/fp16 before their products (the model in
    tools/torch_flash_bwd_cpu_model.py) keeps dq, dk and dv within
    chip_smoke's BWD_ROW_RTOL of the plain backward, row by row, with
    chip_smoke's own error measure (a row's denominator floored at the
    dtype's smallest normal)."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   .to(dtype) for _ in range(4))
    ref = att.chunked_attention_grads(q, k, v, do, causal, sm_scale)
    got = cpu_model.tensor_core_rounding_model(q, k, v, do, causal,
                                               sm_scale)
    _, rels = cs._grad_errors(got, ref)
    assert max(rels) <= cs.BWD_ROW_RTOL[dtype], rels
    assert max(rels) > 0  # the roundings do show


SHARP_CASES = [  # chip_smoke's sm_scale-0.5 backward cases, D 16 and 128
    ((1, 1, 16, 16), False), ((2, 4, 200, 64), True),
    ((2, 4, 200, 32), True), ((2, 4, 200, 16), True),
    ((2, 4, 200, 128), True),
]


@pytest.fixture
def two_threads():
    """Two torch threads for the 20-seed sweeps: the suite runs several
    workers on one machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _sharp_inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
            for _ in range(4)]


def _stand_in(kind, q, k, v, do, causal):
    """A kernel's stand-in on the CPU: the plain version in q-chunks of 64
    (other summation orders of dk and dv), or the CPU model of the kernel
    that the card runs for this dtype (16-bit P and dS for bf16/fp16, the
    three-way bf16 split for fp32)."""
    if kind == "plain":
        return att.chunked_attention_grads(q, k, v, do, causal,
                                           cs.SHARP_SCALE, chunk=64)
    if q.dtype == torch.float32:
        return cpu_model.split_attention_grads(q, k, v, do, causal,
                                               cs.SHARP_SCALE)
    return cpu_model.tensor_core_rounding_model(q, k, v, do, causal,
                                                cs.SHARP_SCALE)


@pytest.mark.parametrize("kind", ["plain", "model"])
@pytest.mark.parametrize("shape,causal", SHARP_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_sharp_row_check_passes_stand_ins_at_20_seeds(two_threads, dtype,
                                                      shape, causal, kind):
    """chip_smoke's check of the sharp cases (sharp_row_check: each row
    against fp64, the error taken against the size of the terms the row
    sums, at SHARP_ROW_C times the plain version's own error plus
    BWD_ROW_RTOL) passes a stand-in for the kernel at 20 seeds."""
    for seed in range(20):
        q, k, v, do = _sharp_inputs(shape, dtype, seed)
        got = _stand_in(kind, q, k, v, do, causal)
        plain = att.chunked_attention_grads(q, k, v, do, causal,
                                            cs.SHARP_SCALE)
        exact, terms = attention_grads_fp64(q, k, v, do, causal,
                                            cs.SHARP_SCALE)
        check = sharp_row_check(got, plain, exact, terms,
                                cs.BWD_ROW_RTOL[dtype])
        assert check["ok"], (seed, check)


@pytest.mark.parametrize("shape,causal", SHARP_CASES[:2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharp_row_check_fails_a_planted_error(dtype, shape, causal):
    """An error of 4 times a row's limit (in units of the row's largest
    term size), planted in dq's row where the plain version lies farthest
    from fp64, fails the check."""
    q, k, v, do = _sharp_inputs(shape, dtype, 0)
    plain = att.chunked_attention_grads(q, k, v, do, causal, cs.SHARP_SCALE)
    exact, terms = attention_grads_fp64(q, k, v, do, causal, cs.SHARP_SCALE)
    rtol = cs.BWD_ROW_RTOL[dtype]
    assert sharp_row_check(plain, plain, exact, terms, rtol)["ok"]
    floor = torch.finfo(dtype).tiny
    rows = row_errors(plain, exact, terms, floor)[0]
    idx = np.unravel_index(int(rows.argmax()), tuple(rows.shape))
    limit = SHARP_ROW_C * rows[idx].item() + rtol
    scale = terms[0][idx].max().clamp_min(floor).item()
    bad = [g.clone() for g in plain]
    bad[0][idx + (0,)] += 4 * limit * scale
    check = sharp_row_check(bad, plain, exact, terms, rtol)
    assert not check["ok"] and check["worst"] > 2.5, check
