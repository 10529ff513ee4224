"""MoE and the GPipe pipeline of the PyTorch package against the JAX
package, case for case with ``tests/test_moe.py`` (routing against a
per-token computation, sharded against unsharded, capacity drops,
gradients) and ``tests/test_pipeline.py`` (its parametrised schedules,
differentiability, training).

The JAX side runs on the virtual CPU devices of ``tests/conftest.py``,
the port's sharded runs on 8 gloo ranks of one ``RankPool`` started once
for the file (``tests/torch_parallel_cases.py``); unsharded port runs are
in this process.  Inputs: the JAX package's seeded params and inputs,
as numpy.  Bars: the JAX tests' own (MoE rtol 1e-4, atol 1e-5; pipeline
forward rtol 1e-5, atol 1e-6, gradients rtol 1e-4, atol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.models.moe import init_moe_params, moe_ffn
from mxnet_tpu.parallel.mesh import make_mesh
from mxnet_tpu.parallel.pipeline import pipeline_apply

import torch_parallel_cases as cases
from mxnet_tpu_torch.models import moe as tmoe
from mxnet_tpu_torch.test_utils import RankPool

WORLD = 8
MOE_TOL = dict(rtol=1e-4, atol=1e-5)
PIPE_TOL = dict(rtol=1e-5, atol=1e-6)
PIPE_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(WORLD, timeout=120,
                  workdir=str(tmp_path_factory.mktemp("ranks"))) as p:
        yield p


# -- MoE ----------------------------------------------------------------------

def _setup(b=2, s=8, d=6, d_ff=10, n_experts=4, seed=0):
    """``tests/test_moe.py``'s draw, as numpy."""
    params = init_moe_params(jax.random.PRNGKey(seed), d, d_ff, n_experts)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (b, s, d),
                          jnp.float32)
    return np.asarray(x), {n: np.asarray(a) for n, a in params.items()}


def _port(x, params, **kw):
    return tmoe.moe_ffn(torch.tensor(x),
                        {n: torch.tensor(a) for n, a in params.items()},
                        **kw).numpy()


def _jax_moe(x, params, cf):
    return np.asarray(jax.jit(lambda p, xx: moe_ffn(
        xx, p, capacity_factor=cf))(params, jnp.asarray(x)))


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation, in numpy."""
    return 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi) * (x + 0.044715 * x ** 3)))


def test_moe_matches_per_token_direct_compute():
    """With capacity >= tokens nothing drops: the routed output is
    gate_prob * FFN_argmax_expert(token), computed directly, and the JAX
    package's output."""
    x, params = _setup()
    cf = float(x.shape[0] * x.shape[1])
    out = _port(x, params, capacity_factor=cf)
    flat = x.reshape(-1, x.shape[-1])
    logits = (flat @ params["gate_w"]).astype(np.float64)
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    gates /= gates.sum(-1, keepdims=True)
    expect = np.zeros_like(flat)
    for i, tok in enumerate(flat):
        e = int(np.argmax(gates[i]))
        h = _gelu(tok @ params["expert_w1"][e] + params["expert_b1"][e])
        expect[i] = float(gates[i, e]) * (h @ params["expert_w2"][e])
    np.testing.assert_allclose(out.reshape(flat.shape), expect, **MOE_TOL)
    np.testing.assert_allclose(out, _jax_moe(x, params, cf), **MOE_TOL)


def _jax_moe_and_grads(x, params, cf, dy, mesh=None):
    def loss(p, xx):
        out = moe_ffn(xx, p, capacity_factor=cf, mesh=mesh)
        return jnp.sum(out * dy), out
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    return (np.asarray(out), np.asarray(gx),
            {n: np.asarray(g) for n, g in gp.items()})


@pytest.mark.parametrize("cf", [1.25, 0.125])
def test_moe_sharded_matches_unsharded(pool, cf):
    """Expert parallelism over ``model 4`` (``data 2 x model 4``, two
    experts a rank) against the port unsharded and the JAX package's
    sharded run: output, dropped tokens and gradients (capacity factor
    1.25, and 0.125 where tokens drop)."""
    x, params = _setup(b=4, s=8, d=8, d_ff=16, seed=0)
    dy = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    mesh = make_mesh({"data": 2, "model": 4})
    jout, jdx, jgrads = _jax_moe_and_grads(x, params, cf, dy, mesh)
    for res in pool.run(cases.moe, params, x, {"data": 2, "model": 4},
                        cf, dy):
        sh, whole = res["sharded"], res["whole"]
        assert sh["experts_here"] == 1 and whole["experts_here"] == 4
        for got in (sh, whole):
            np.testing.assert_allclose(got["out"], jout, **MOE_TOL)
            np.testing.assert_allclose(got["dx"], jdx, **MOE_TOL)
            for n, g in jgrads.items():
                np.testing.assert_allclose(got["grads"][n], g, err_msg=n,
                                           **MOE_TOL)
        dropped = np.abs(sh["out"]).reshape(-1, 8).max(axis=1) == 0
        np.testing.assert_array_equal(
            dropped, np.abs(jout).reshape(-1, 8).max(axis=1) == 0)
        if cf < 1:
            assert dropped.any()


def test_moe_capacity_drops_overflow_tokens():
    """Tokens past an expert's capacity contribute zero; the same rows
    drop in both packages, and the kept rows agree with the uncapped
    routing."""
    x, params = _setup(b=2, s=16, d=6)
    full = _port(x, params, capacity_factor=32.0).reshape(-1, 6)
    tight = _port(x, params, capacity_factor=0.125).reshape(-1, 6)
    zero_rows = np.abs(tight).max(axis=1) == 0
    assert zero_rows.any(), "tight capacity dropped nothing"
    jtight = _jax_moe(x, params, 0.125).reshape(-1, 6)
    np.testing.assert_array_equal(zero_rows, np.abs(jtight).max(axis=1) == 0)
    kept = ~zero_rows
    np.testing.assert_allclose(tight[kept], full[kept], **MOE_TOL)
    np.testing.assert_allclose(tight, jtight, **MOE_TOL)


def test_moe_gradients_flow_to_all_param_groups():
    x, params = _setup()
    tp = {n: torch.tensor(a).requires_grad_() for n, a in params.items()}
    (tmoe.moe_ffn(torch.tensor(x), tp) ** 2).sum().backward()

    def loss(p, xx):
        return jnp.sum(moe_ffn(xx, p) ** 2)
    grads = jax.jit(jax.grad(loss))(
        {n: jnp.asarray(a) for n, a in params.items()}, jnp.asarray(x))
    for name, g in grads.items():
        ours = tp[name].grad.numpy()
        assert np.isfinite(ours).all(), name
        if name != "gate_w":
            assert float(np.abs(ours).sum()) > 0, name
        np.testing.assert_allclose(ours, np.asarray(g), err_msg=name,
                                   **MOE_TOL)


# -- the pipeline -------------------------------------------------------------

def _stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _pipe_setup(n_stages, d=6, batch=8, seed=0):
    """``tests/test_pipeline.py``'s draw."""
    rng = np.random.RandomState(seed)
    params = {
        "w": (rng.randn(n_stages, d, d) / np.sqrt(d)).astype(np.float32),
        "b": (rng.randn(n_stages, d) * 0.1).astype(np.float32),
    }
    x = rng.randn(batch, d).astype(np.float32)
    return params, x


def _sequential(params, x, n_stages):
    for i in range(n_stages):
        x = _stage_fn(jax.tree_util.tree_map(lambda p: p[i], params), x)
    return x


def _pipe_mesh(n):
    return make_mesh({"pipe": n}, jax.devices()[:n])


@pytest.mark.parametrize("n_stages,n_micro", [(2, 2), (2, 4), (4, 4),
                                              (4, 8), (8, 8)])
def test_pipeline_matches_sequential(pool, n_stages, n_micro):
    params, x = _pipe_setup(n_stages)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    ref = np.asarray(_sequential(jp, jnp.asarray(x), n_stages))
    theirs = np.asarray(pipeline_apply(_stage_fn, jp, jnp.asarray(x),
                                       _pipe_mesh(n_stages), n_micro))
    res = pool.run(cases.pipeline_run, params, x, n_stages, n_micro)
    assert res[n_stages:] == [None] * (WORLD - n_stages)
    for stage, r in enumerate(res[:n_stages]):
        np.testing.assert_allclose(r["out"], ref, **PIPE_TOL)
        np.testing.assert_allclose(r["out"], theirs, **PIPE_TOL)
        # one P2P exchange a tick where the stage sends or receives: an
        # end stage at M ticks, a middle one at M + 1, forward and back
        middle = 0 < stage < n_stages - 1
        assert r["p2p"] == 2 * (n_micro + middle)


def test_pipeline_is_differentiable(pool):
    n_stages = 4
    params, x = _pipe_setup(n_stages)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    mesh = _pipe_mesh(n_stages)

    def loss(p):
        return jnp.sum(pipeline_apply(_stage_fn, p, jnp.asarray(x), mesh,
                                      4) ** 2)

    def ref_loss(p):
        return jnp.sum(_sequential(p, jnp.asarray(x), n_stages) ** 2)
    g = jax.grad(loss)(jp)
    g_ref = jax.grad(ref_loss)(jp)
    for r in pool.run(cases.pipeline_run, params, x, n_stages, 4)[:4]:
        for k in params:
            np.testing.assert_allclose(r["grads"][k], np.asarray(g_ref[k]),
                                       err_msg=k, **PIPE_GRAD_TOL)
            np.testing.assert_allclose(r["grads"][k], np.asarray(g[k]),
                                       err_msg=k, **PIPE_GRAD_TOL)


def test_pipeline_trains(pool):
    """A pipelined regression net learns (25 SGD steps at lr 0.5), with
    the JAX package's losses step for step."""
    n_stages = 2
    params, x = _pipe_setup(n_stages, batch=16)
    rng = np.random.RandomState(1)
    target = (rng.randn(16, 6).astype(np.float32) * 0.3).astype(np.float32)
    mesh = _pipe_mesh(n_stages)

    @jax.jit
    def step(p):
        def loss(p):
            out = pipeline_apply(_stage_fn, p, jnp.asarray(x), mesh, 4)
            return jnp.mean((out - target) ** 2)
        l, g = jax.value_and_grad(loss)(p)
        return jax.tree_util.tree_map(lambda a, b: a - 0.5 * b, p, g), l
    jp, jlosses = {n: jnp.asarray(a) for n, a in params.items()}, []
    for _ in range(25):
        jp, l = step(jp)
        jlosses.append(float(l))
    losses = pool.run(cases.pipeline_run, params, x, n_stages, 4, target,
                      25)[0]
    assert losses[-1] < losses[0] * 0.6, losses[::6]
    np.testing.assert_allclose(losses, jlosses, **PIPE_GRAD_TOL)
