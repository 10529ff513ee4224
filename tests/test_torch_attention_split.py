"""The fp32 flash-attention kernels' three-way bf16 split, modelled on the CPU.

``ops/csrc/flash_attn_fwd_f32_sm90.cu`` and ``flash_attn_bwd_f32_sm90.cu``
take fp32 products on the tensor cores as six products of bf16 parts
(``sm90_common.cuh``: ``split3``).  The kernels run only on the card, where
``chip_smoke.py`` holds them against the plain versions; here the split's
arithmetic, as ``tools/torch_flash_bwd_cpu_model.py`` models it in plain
PyTorch, is held on the CPU: the split is exact over the range the kernels
state, the forward model matches the JAX package's ``flash_attention``
(the Pallas kernel in interpret mode, and ``local_attention``) to
chip_smoke's fp32 limits, and the gradient model matches the plain backward
to chip_smoke's fp32 backward limit in sharp-softmax rows.
"""
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.parallel.ring_attention import local_attention

from mxnet_tpu_torch.ops import attention as att

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke", "chip_smoke.py")
model = _load("torch_flash_bwd_cpu_model",
              "tools/torch_flash_bwd_cpu_model.py")

F32 = torch.float32
# the range over which the split is exact: 0 and 2^-110 <= |x| < 2^128 - 2^119
LOW_BITS, HIGH_BITS = 0x08800000, 0x7F7F8000   # 2^-110, 2^128 - 2^119


def _bits(*words):
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.float32))


def _exact(x):
    x0, x1, x2 = model.split_bf16x3(x)
    for part in (x0, x1, x2):  # each part is a bf16 value
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    return (x2 + x1) + x0


def test_split_is_exact_over_its_range():
    """x0 + x1 + x2 == x bit for bit: random fp32 bit patterns over the
    whole exact range, and its edges, ties and all-ones mantissas, each
    with both signs."""
    rng = np.random.RandomState(0)
    words = rng.randint(LOW_BITS, HIGH_BITS, size=200_000, dtype=np.int64)
    x = torch.from_numpy(words.astype(np.uint32).view(np.float32))
    x = torch.cat([x, -x])
    edges = _bits(
        0x00000000, LOW_BITS, LOW_BITS + 1, 0x08FFFFFF,  # 0, the low end
        HIGH_BITS - 1, 0x7F7F0000,          # the high end, bf16's largest
        0x3F800000, 0x3F800001, 0x3FFFFFFF,  # 1, 1 + 2^-23, 2 - 2^-23
        0x3F808000, 0x3F818000,             # ties of x0, to even
        0x3F807FFF, 0x3F808001,             # just off a tie
        0x4B7FFFFF, 0x33FFFFFF)             # all 24 bits set
    x = torch.cat([x, edges, -edges])
    got = _exact(x)
    nonzero = x != 0   # -0 comes back as +0, which the products do not see
    assert torch.equal(got[nonzero].view(torch.int32),
                       x[nonzero].view(torch.int32))
    assert (got[~nonzero] == 0).all()
    # the parts shrink by bf16's 8 bits each
    x0, x1, x2 = model.split_bf16x3(x)
    assert (x1.abs() <= x0.abs() * 2.0 ** -8).all()
    assert (x2.abs() <= x1.abs() * 2.0 ** -8).all()


def test_split_range_bounds_are_tight():
    """Just outside the stated range the split stops being exact: below
    2^-110 x2 needs bits finer than bf16's smallest subnormal, and from
    2^128 - 2^119 on x0 rounds to infinity."""
    below = _bits(0x00800001)                  # 2^-126 (1 + 2^-23)
    assert not torch.equal(_exact(below), below)
    assert torch.isinf(model.split_bf16x3(_bits(HIGH_BITS))[0]).all()


def _np_inputs(shape, seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


FORWARD_CASES = [  # (shape, causal, sm_scale, jax block size)
    ((1, 2, 40, 64), True, 0.5, 16),
    ((2, 2, 64, 64), False, None, 32),
    ((1, 2, 48, 128), True, None, 16),
    ((1, 1, 33, 128), False, 0.5, 16),
]


def _row_rel(got, ref):
    diff = np.abs(got - ref)
    return (diff.max(-1) / np.maximum(np.abs(ref).max(-1), 1e-30)).max()


@pytest.mark.parametrize("shape,causal,sm_scale,block", FORWARD_CASES)
def test_split_forward_model_matches_jax(shape, causal, sm_scale, block):
    """The fp32 forward kernel's arithmetic (split products, log2-unit
    softmax) against the Pallas kernel in interpret mode and the exact
    jnp reference, held to chip_smoke's fp32 ATOL and ROW_RTOL."""
    q, k, v = _np_inputs(shape, seed=sum(shape))
    got = model.split_attention(*map(torch.from_numpy, (q, k, v)), causal,
                                sm_scale).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(pk.flash_attention(jq, jk, jv, causal, sm_scale,
                                           block, block, True))
    exact = np.asarray(local_attention(jq, jk, jv, causal=causal,
                                       sm_scale=sm_scale))
    for ref in (pallas, exact):
        assert np.abs(got - ref).max() <= cs.ATOL[F32]
        assert _row_rel(got, ref) <= cs.ROW_RTOL[F32]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("shape,causal,sm_scale", [
    ((2, 4, 200, 64), True, 0.5),    # sharp softmax: ds cancels
    ((1, 3, 130, 128), True, None),
    ((2, 4, 200, 32), True, 0.5),    # the sharp case at D 32 and 16
    ((2, 4, 200, 16), True, 0.5),
])
def test_split_grads_model_within_bwd_limits(shape, causal, sm_scale, seed):
    """The plain backward's formula with every product split as the fp32
    backward kernel splits it, against ``chunked_attention_grads``, with
    chip_smoke's own error measure: within BWD_ATOL and BWD_ROW_RTOL for
    fp32 (the split alone reads at most 2.2e-4 row-relative over ten
    seeds at the sharp case)."""
    q, k, v, do = map(torch.from_numpy, _np_inputs(shape, seed, n=4))
    ref = att.chunked_attention_grads(q, k, v, do, causal, sm_scale)
    got = model.split_attention_grads(q, k, v, do, causal, sm_scale)
    err, rels = cs._grad_errors(got, ref)
    assert err <= cs.BWD_ATOL[F32]
    assert max(rels) <= cs.BWD_ROW_RTOL[F32], rels


def test_split_matmul_beats_a_single_bf16_or_tf32_product():
    """Six split products carry almost fp32's 24 bits: against an fp64
    product the split lies near plain fp32, far below one bf16 product or
    a TF32-like product (inputs rounded to 11 bits)."""
    a, b = (torch.from_numpy(x) for x in _np_inputs((64, 256), 5, n=2))
    b = b.T.contiguous()
    exact = a.double() @ b.double()
    scale = exact.abs().max().item()

    def err(c):
        return (c.double() - exact).abs().max().item() / scale
    tf32 = [(x.view(torch.int32) + 0x1000 & ~0x1FFF).view(F32)
            for x in (a, b)]
    split, plain = err(model.split_matmul(a, b)), err(a @ b)
    assert split <= 4 * plain
    assert 100 * split < err(a.bfloat16().float() @ b.bfloat16().float())
    assert 100 * split < err(tf32[0] @ tf32[1])
