"""Transformer LM of the PyTorch package against the JAX package.

The JAX package's params go through ``params_from_jax``; the same numpy
tokens go through both forwards on the CPU (the JAX side through its
``local_attention``, the port through the plain attention version).
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.models import transformer as jt

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.models import transformer as tt

# fp32 on the CPU: matmuls and reductions sum in other orders
ATOL = 1e-4
SMALL = dict(vocab=32, d_model=16, n_heads=4, d_ff=32, n_layers=2,
             max_len=128)


def _configs(dtype=jnp.float32):
    tdtype = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    return (jt.TransformerLMConfig(dtype=dtype, **SMALL),
            tt.TransformerLMConfig(dtype=tdtype, **SMALL))


def _jax_params(jcfg, seed=0):
    p = jt.init_transformer_params(jax.random.PRNGKey(seed), jcfg)
    return {n: np.asarray(a) for n, a in p.items()}


def _tokens(vocab, b, s, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (b, s)).astype(np.int32),
            rng.randint(0, vocab, (b, s)).astype(np.int32))


# S=128 is the length at which the JAX package's TPU gate picks its kernel
@pytest.mark.parametrize("seq", [16, 128])
def test_forward_and_nll_match_jax(seq):
    jcfg, tcfg = _configs()
    np_params = _jax_params(jcfg)
    tokens, labels = _tokens(jcfg.vocab, 2, seq, seed=seq)
    ref_logits = np.asarray(jt.transformer_forward(
        {n: jnp.asarray(a) for n, a in np_params.items()},
        jnp.asarray(tokens), jcfg))
    ref_nll = float(jt._lm_loss_fn(jcfg, None, "seq")(
        {n: jnp.asarray(a) for n, a in np_params.items()},
        jnp.asarray(tokens), jnp.asarray(labels)))

    params = tt.params_from_jax(np_params, tcfg, device="cpu")
    with torch.no_grad():
        logits = tt.transformer_forward(params, torch.from_numpy(tokens),
                                        tcfg)
        nll = tt.lm_nll(params, torch.from_numpy(tokens),
                        torch.from_numpy(labels), tcfg)
        module_logits = tt.TransformerLM(tcfg, params)(
            torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=0, atol=ATOL)
    assert abs(float(nll) - ref_nll) < ATOL
    assert torch.equal(module_logits, logits)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_jax_keeps_names_layouts_and_values(dtype):
    jcfg, tcfg = _configs(dtype)
    np_params = _jax_params(jcfg, seed=1)
    params = tt.params_from_jax(np_params, tcfg, device="cpu")
    assert set(params) == set(np_params)
    for name, a in np_params.items():
        t = params[name]
        assert tuple(t.shape) == a.shape, name
        assert t.dtype == tcfg.dtype
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))
    hd = SMALL["d_model"] // SMALL["n_heads"]
    assert tuple(params["layer0_wq"].shape) == (16, 4, hd)
    assert tuple(params["layer0_wo"].shape) == (4, hd, 16)


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_params_from_jax_rejects_mismatch(fault):
    jcfg, tcfg = _configs()
    np_params = _jax_params(jcfg)
    if fault == "missing":
        del np_params["layer1_w2"]
    else:
        np_params["layer0_wq"] = np_params["layer0_wq"].reshape(16, 16)
    with pytest.raises(MXNetError):
        tt.params_from_jax(np_params, tcfg, device="cpu")


def test_init_matches_jax_shapes_and_scales():
    widths = dict(vocab=512, d_model=128, n_heads=4, d_ff=256, n_layers=1,
                  max_len=256)
    jp = jt.init_transformer_params(jax.random.PRNGKey(0),
                                    jt.TransformerLMConfig(**widths))
    tp = tt.init_transformer_params(torch.Generator().manual_seed(0),
                                    tt.TransformerLMConfig(**widths),
                                    device="cpu")
    assert set(tp) == set(jp)
    for name, a in jp.items():
        a = np.asarray(a)
        t = tp[name].numpy()
        assert t.shape == a.shape and t.dtype == np.float32, name
        if name.endswith("_scale"):
            assert (t == 1).all()
        elif name.endswith("b1"):
            assert (t == 0).all()
        else:
            shape = a.shape
            fan_in = (int(np.prod(shape[:-1])) if name.endswith("wo")
                      else shape[0])
            want = 1.0 / math.sqrt(fan_in)
            # >= 32k samples each: the sample std is within 3% of its value
            assert abs(t.std() / want - 1) < 0.03, name
            assert abs(t.std() / a.std() - 1) < 0.05, name
            assert abs(t.mean()) < 0.05 * want, name


def test_rmsnorm_and_gelu_follow_jax_in_bf16():
    rng = np.random.RandomState(7)
    x = rng.randn(3, 5, 16).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    js = jnp.asarray(scale, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    ts = torch.from_numpy(scale).to(torch.bfloat16)
    ref = np.asarray(jt._rmsnorm(jx, js).astype(jnp.float32))
    out = tt._rmsnorm(tx, ts)
    assert out.dtype == torch.bfloat16
    # the same op order: normalise in fp32, cast, then scale in bf16
    np.testing.assert_array_equal(out.float().numpy(), ref)
    g = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.nn.gelu(x)),
                               rtol=0, atol=1e-6)


def test_sequence_longer_than_max_len_raises():
    _, tcfg = _configs()
    params = tt.init_transformer_params(torch.Generator(), tcfg,
                                        device="cpu")
    with pytest.raises(MXNetError):
        tt.transformer_forward(params, torch.zeros(1, 129, dtype=torch.long),
                               tcfg)
