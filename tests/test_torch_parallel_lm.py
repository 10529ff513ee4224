"""The sharded LM of the PyTorch package against the JAX package: ring
attention (forward and gradients, causal and full), the transformer's
forward and 3 steps of both train steps on a ``data 2 x seq 2 x model 2``
mesh, the ZeRO-1 momenta sharded over ``data``, and the ZeRO-1 update bit
for bit on one reduced gradient.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``,
the port's on 8 gloo ranks of one ``RankPool`` started once for the file
(``tests/torch_parallel_cases.py``).  Both start from the JAX package's
global params and take the same numpy batch.  Bars: the JAX package's own
sharded-against-unsharded ones, atol 2e-4 on logits
(``tests/test_models.py:31-32``) and rtol/atol 2e-4 on parameters
(``:77-80``), 1e-5 on the loss (``:76``); the ring's, atol 1e-5
(``tests/test_parallel.py:66``), also for its gradients.  Both packages'
rings compute in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mxnet_tpu.models import transformer as jt
from mxnet_tpu.parallel import mesh as jmesh
from mxnet_tpu.parallel.ring_attention import (local_attention,
                                               ring_attention_sharded)

import torch_parallel_cases as cases
from mxnet_tpu_torch.test_utils import RankPool

WORLD = 8
SMALL = cases.SMALL
STEPS = 3
LOGITS_ATOL = 2e-4
PARAM_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_ATOL = 1e-5
RING_ATOL = 1e-5


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(WORLD, timeout=120,
                  workdir=str(tmp_path_factory.mktemp("ranks"))) as p:
        yield p


# -- ring attention -----------------------------------------------------------

RING_CASES = {  # tests/test_parallel.py's two cases
    "full": ((2, 3, 16, 8), False, 0),
    "causal": ((1, 2, 16, 4), True, 1),
}


@pytest.fixture(scope="module")
def ring_runs(pool):
    out = {}
    for name, (shape, causal, seed) in RING_CASES.items():
        rng = np.random.RandomState(seed)
        q, k, v, do = (rng.randn(*shape).astype(np.float32)
                       for _ in range(4))
        mesh = jmesh.auto_mesh(("seq",))

        def loss(q, k, v):
            out = ring_attention_sharded(q, k, v, mesh, causal=causal)
            return jnp.sum(out * do), out
        (_, jout), jgrads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        ref = local_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal)
        out[name] = (pool.run(cases.ring_attention, q, k, v, do, causal),
                     [np.asarray(jout)] + [np.asarray(g) for g in jgrads],
                     np.asarray(ref))
    return out


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_attention_matches_local(ring_runs, name):
    """``tests/test_parallel.py``'s ring cases: the port's ring over 8
    ranks against the JAX package's ``local_attention`` and against the
    port's own on the whole sequence, forward and gradients."""
    ranks, _, ref = ring_runs[name]
    got, want, _ = ranks[0]
    np.testing.assert_allclose(got[0], ref, atol=RING_ATOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=RING_ATOL)


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_attention_matches_jax_ring(ring_runs, name):
    ranks, theirs, _ = ring_runs[name]
    for got, _, p2p in ranks:
        for g, w in zip(got, theirs):
            np.testing.assert_allclose(g, w, atol=RING_ATOL)
        # the forward's 7 exchanges of K/V and the backward's 8 of K/V
        # and dK/dV, one batch_isend_irecv each
        assert p2p == (WORLD - 1) + WORLD


# -- the LM on data x seq x model -------------------------------------------

def _lm_mesh():
    return jmesh.make_mesh(cases.LM_MESH)


def _batch(cfg, b, s, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, cfg.vocab, (b, s)).astype(np.int32),
            rng.randint(0, cfg.vocab, (b, s)).astype(np.int32))


@pytest.fixture(scope="module")
def lm_setup():
    cfg = jt.TransformerLMConfig(**SMALL)
    params = jt.init_transformer_params(jax.random.PRNGKey(0), cfg)
    np_params = {n: np.asarray(a) for n, a in params.items()}
    return cfg, np_params


@pytest.fixture(scope="module")
def single_forward(lm_setup):
    """The JAX package's single-device forward of the setup's params."""
    cfg, np_params = lm_setup
    fwd = jax.jit(lambda p, t: jt.transformer_forward(p, t, cfg))
    jparams = {n: jnp.asarray(a) for n, a in np_params.items()}
    return lambda tokens: np.asarray(fwd(jparams, jnp.asarray(tokens)))


def test_forward_sharded_matches_jax(pool, lm_setup, single_forward):
    """``tests/test_models.py::test_forward_sharded_matches_unsharded``:
    the port on 8 ranks against the JAX package's sharded forward and its
    single-device one."""
    cfg, np_params = lm_setup
    tokens, _ = _batch(cfg, 4, 16)
    mesh = _lm_mesh()
    jparams = {n: jnp.asarray(a) for n, a in np_params.items()}
    sharded = jax.jit(lambda p, t: jt.transformer_forward(p, t, cfg, mesh))(
        jparams, jnp.asarray(tokens))
    single = single_forward(tokens)
    for out in pool.run(cases.lm_forward, np_params, tokens):
        np.testing.assert_allclose(out, np.asarray(sharded),
                                   atol=LOGITS_ATOL)
        np.testing.assert_allclose(out, single, atol=LOGITS_ATOL)


@pytest.mark.parametrize("shape", [{"seq": 4, "model": 2},
                                   {"data": 4, "model": 2},
                                   {"data": 2, "seq": 4}])
def test_forward_on_other_meshes(pool, lm_setup, single_forward, shape):
    """The forward on meshes that leave out an axis, against the JAX
    package's single-device forward: ring without data, tensor-parallel
    flash without seq, ring without model."""
    cfg, np_params = lm_setup
    tokens, _ = _batch(cfg, 4, 16, seed=3)
    out = pool.run(cases.lm_forward, np_params, tokens, shape)[0]
    np.testing.assert_allclose(out, single_forward(tokens),
                               atol=LOGITS_ATOL)


def _jax_train(cfg, np_params, tokens, labels, builder, momentum=0.9,
               steps=STEPS, lr=0.1):
    mesh = _lm_mesh()
    params = {n: jmesh.shard_put(a, jmesh.named_sharding(
        mesh, jt._param_specs(cfg)[n][1])) for n, a in np_params.items()}
    tok, lab = jt.place_batch(tokens, labels, mesh)
    losses = []
    if builder == "plain":
        step = jt.make_train_step(cfg, mesh, lr=lr)
        for _ in range(steps):
            params, loss = step(params, tok, lab)
            losses.append(float(loss))
        return losses, {n: np.asarray(a) for n, a in params.items()}, None
    step, momenta = jt.make_train_step_zero1(cfg, mesh, params, lr=lr,
                                             momentum=momentum)
    sharded = {n for n, m in momenta.items()
               if "data" in tuple(m.sharding.spec)}
    for _ in range(steps):
        params, momenta, loss = step(params, momenta, tok, lab)
        losses.append(float(loss))
    return (losses, {n: np.asarray(a) for n, a in params.items()},
            ({n: np.asarray(a) for n, a in momenta.items()}, sharded))


@pytest.fixture(scope="module")
def train_runs(pool, lm_setup):
    cfg, np_params = lm_setup
    tokens, labels = _batch(cfg, 8, 16)
    return {b: (pool.run(cases.lm_train, np_params, tokens, labels, STEPS,
                         0.1, b)[0],
                _jax_train(cfg, np_params, tokens, labels, b))
            for b in ("plain", "zero1")}


@pytest.mark.parametrize("builder", ["plain", "zero1"])
def test_train_steps_match_jax(train_runs, builder):
    ours, (losses, params, momenta) = train_runs[builder]
    np.testing.assert_allclose(ours["losses"], losses, atol=LOSS_ATOL)
    assert set(ours["params"]) == set(params)
    for n, a in params.items():
        np.testing.assert_allclose(ours["params"][n], a, err_msg=n,
                                   **PARAM_TOL)
    if momenta is not None:
        for n, a in momenta[0].items():
            assert np.abs(a).max() > 0, n
            np.testing.assert_allclose(ours["momenta"][n], a, err_msg=n,
                                       **PARAM_TOL)


def test_zero1_momenta_shard_over_data(train_runs):
    """The momenta that the JAX package shards over ``data`` are the
    port's that hold rows/2 rows on each rank (the rest whole, or split
    by ``model`` as their weight is), and each rank's momentum bytes are
    ``state_bytes``' per-device figure."""
    ours, (_, _, (_, jax_sharded)) = train_runs["zero1"]
    shapes, pshapes = ours["momentum_shapes"], ours["param_shapes"]
    sharded = {n for n in shapes if shapes[n] != pshapes[n]}
    assert sharded == jax_sharded and sharded
    for n in sharded:
        assert shapes[n] == (pshapes[n][0] // 2,) + pshapes[n][1:]
    assert ours["momentum_bytes"] == ours["state_bytes"][0]
    assert ours["state_bytes"][0] < ours["state_bytes"][1]


def test_zero1_step_matches_plain_sgd(pool, lm_setup):
    """``tests/test_models.py::test_zero1_step_matches_plain_sgd`` on the
    port's mesh: momentum 0 is plain SGD with another placement."""
    cfg, np_params = lm_setup
    tokens, labels = _batch(cfg, 8, 16)
    plain = pool.run(cases.lm_train, np_params, tokens, labels, STEPS, 0.3,
                     "plain")[0]
    z = pool.run(cases.lm_train, np_params, tokens, labels, STEPS, 0.3,
                 "zero1", 0.0)[0]
    assert abs(plain["losses"][-1] - z["losses"][-1]) < LOSS_ATOL
    for n, a in plain["params"].items():
        np.testing.assert_allclose(z["params"][n], a, err_msg=n, **PARAM_TOL)


def test_train_step_loss_decreases(pool, lm_setup):
    """``tests/test_models.py::test_train_step_loss_decreases`` on the
    port's mesh: 20 steps at lr 0.5."""
    cfg, np_params = lm_setup
    tokens, labels = _batch(cfg, 8, 16)
    losses = pool.run(cases.lm_train, np_params, tokens, labels, 20, 0.5,
                      "plain")[0]["losses"]
    assert losses[-1] < losses[0] * 0.7, losses[::5]
    assert np.isfinite(losses[-1])


def test_zero1_update_bit_for_bit_on_one_reduced_gradient(pool):
    """Given one reduced gradient, the ZeRO-1 update over 8 ranks is the
    replicated update bit for bit (arXiv:2004.13336), for the weights
    that shard (leading dim divisible by 8) and the ones that do not."""
    shapes = [(16, 3), (8,), (5, 2), (24, 2, 2), (3,)]
    for res in pool.run(cases.zero_bitwise, shapes, 7):
        assert res["sharded"] == [True, True, False, True, False]
        assert res["params_differ"] == [0] * len(shapes)
        assert res["momenta_differ"] == [0] * len(shapes)
