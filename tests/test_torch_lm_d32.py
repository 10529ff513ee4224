"""The LM at head dims 32 and 16 in the PyTorch package against the JAX package.

The D-32 LM (``chip_smoke.py`` phases 13 and 14, Pythia-31M's widths on the
card) takes the tensor-core kernels at D 32; the JAX package's default
``TransformerLMConfig`` (d_model 64, 4 heads) is D 16.  Here, on the CPU,
small LMs at those head dims: the port's forward (logits and NLL) and three
``make_train_step`` steps in fp32 against the JAX package's on a
one-device mesh, from the JAX package's params and one numpy batch.  On
the CPU the port's attention is its plain versions, as the kernels' are on
the card; ``chip_smoke.py`` holds the card against the CPU.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.models import transformer as jt
from mxnet_tpu.parallel.mesh import make_mesh

from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.ops import attention as att

CONFIGS = {  # head dim -> widths
    32: dict(vocab=64, d_model=64, n_heads=2, d_ff=128, n_layers=2,
             max_len=64),
    16: dict(vocab=64, d_model=64, n_heads=4, d_ff=128, n_layers=2,
             max_len=64),
}
STEPS = 3
# fp32 on the CPU, sums in other orders: the forward at
# tests/test_torch_transformer.py's ATOL; the steps at
# tests/test_torch_lm_train.py's fp32 limits (params differ by an fp32 ulp
# or two after 3 steps, the loss by one).
ATOL = 1e-4
TOL = dict(loss=2e-6, params=1e-6)


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    """The JAX package turns x64 on at import; another test may have
    turned it off in this worker.  Two torch threads: the suite runs
    several workers on one machine."""
    prev = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_enable_x64", prev[0])
    torch.set_num_threads(prev[1])


def _setup(head_dim, seed=0):
    widths = CONFIGS[head_dim]
    jcfg = jt.TransformerLMConfig(dtype=jnp.float32, **widths)
    tcfg = tt.TransformerLMConfig(dtype=torch.float32, **widths)
    assert tcfg.d_model // tcfg.n_heads == head_dim
    mesh = make_mesh({"data": 1, "seq": 1, "model": 1}, jax.devices()[:1])
    jparams = jt.init_transformer_params(jax.random.PRNGKey(seed), jcfg,
                                         mesh)
    tparams = tt.params_from_jax({n: np.asarray(a)
                                  for n, a in jparams.items()},
                                 tcfg, device="cpu")
    rng = np.random.RandomState(seed + head_dim)
    tokens, labels = (rng.randint(0, widths["vocab"], (2, 48))
                      .astype(np.int32) for _ in range(2))
    return jcfg, tcfg, mesh, jparams, tparams, tokens, labels


@pytest.mark.parametrize("head_dim", sorted(CONFIGS))
def test_forward_and_nll_match_jax(head_dim):
    jcfg, tcfg, _, jparams, tparams, tokens, labels = _setup(head_dim)
    ref = np.asarray(jt.transformer_forward(jparams, jnp.asarray(tokens),
                                            jcfg))
    ref_nll = float(jt._lm_loss_fn(jcfg, None, "seq")(
        jparams, jnp.asarray(tokens), jnp.asarray(labels)))
    att.reset_launch_count()
    with torch.no_grad():
        logits = tt.transformer_forward(tparams, torch.from_numpy(tokens),
                                        tcfg)
        nll = tt.nll_from_logits(logits, torch.from_numpy(labels))
    assert att.launch_count() == 0
    assert att.design(torch.float32, head_dim) == "wgmma+bf16x3"
    assert att.kernel_width(head_dim) == head_dim
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0, atol=ATOL)
    assert abs(float(nll) - ref_nll) < ATOL


@pytest.mark.parametrize("head_dim", sorted(CONFIGS))
def test_train_steps_match_jax(head_dim):
    jcfg, tcfg, mesh, jp, tp, tokens, labels = _setup(head_dim, seed=1)
    jstep = jt.make_train_step(jcfg, mesh, lr=0.1)
    tstep = tt.make_train_step(tcfg, lr=0.1, device="cpu")
    jtok, jlab = jt.place_batch(tokens, labels, mesh)
    ttok, tlab = tt.place_batch(tokens, labels, device="cpu")
    losses = []
    for i in range(STEPS):
        jp, jloss = jstep(jp, jtok, jlab)
        tp, tloss = tstep(tp, ttok, tlab)
        losses.append(float(tloss))
        assert abs(float(jloss) - float(tloss)) <= TOL["loss"], i
        diff = max(float(np.abs(np.asarray(jp[n], np.float64)
                                - tp[n].double().numpy()).max())
                   for n in tp)
        assert diff <= TOL["params"], (i, diff)
    assert losses[-1] < losses[0]
