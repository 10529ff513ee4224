"""The parallel tier's substrate in the PyTorch package against the JAX
package: the rank mesh (``tests/test_mesh.py``'s cases that have a
counterpart, case for case), the collectives of
``tests/test_parallel.py::test_collectives_shard_map`` and the rest of
the surface with their gradients, ``multihost``'s refusal of an ``nccl``
group on a shared card, and the rank launcher.

The JAX side runs on the virtual CPU devices of ``tests/conftest.py``;
the port's on 4 gloo ranks of one ``RankPool``, started once for the
file (``tests/torch_parallel_cases.py`` holds the rank side).  A mesh of
the port lies over ranks where the JAX package's lies over devices, and
each rank is a process: where a JAX case counts devices or processes,
the port's counts ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mxnet_tpu.parallel import collective as jcol
from mxnet_tpu.parallel import mesh as jmesh

import torch_parallel_cases as cases
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import multihost
from mxnet_tpu_torch.test_utils import RankPool, run_ranks

WORLD = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(WORLD, timeout=60,
                  workdir=str(tmp_path_factory.mktemp("ranks"))) as p:
        yield p


def test_rank_worker_loads_no_jax(pool):
    assert pool.run(cases.forbidden_modules) == [[]] * WORLD


def test_topology_report(pool):
    for r, topo in enumerate(pool.run(cases.topology)):
        assert topo == {"n_devices": WORLD, "n_local_devices": 1,
                        "n_hosts": WORLD, "process_index": r,
                        "platform": "cpu"}


@pytest.mark.parametrize("case,want", [
    ("single", {"data": 1}),
    ("minus_one", {"data": WORLD // 2, "model": 2}),
    ("minus_one_indivisible", "ValueError"),
    ("auto", {"data": 2, "model": 2}),
    ("multihost_faked", {"host": 2, "data": WORLD // 2}),
    ("multihost_uneven", "ValueError"),
    ("multihost_collision", "ValueError"),
    ("multihost_live", {"host": WORLD, "data": 1}),
])
def test_mesh_shapes(pool, case, want):
    """``test_mesh.py``'s construction cases: the JAX package's
    ``factor_devices`` balance, ``-1`` inference and rejects, and the
    faked and live host fleets (a rank is a process here)."""
    res = pool.run(cases.mesh_shapes, case)
    if isinstance(want, str):
        assert res == [want] * WORLD
        return
    assert all(r["shape"] == want for r in res)
    assert list(want) == res[0]["names"]
    if case == "single":
        assert res[0]["coordinate"] == {"data": 0}
        assert all(r["coordinate"] is None for r in res[1:])
    else:
        # every rank has its own coordinate, in row-major order
        coords = [tuple(r["coordinate"].values()) for r in res]
        assert coords == sorted(set(coords))


def test_factor_devices_matches_jax():
    from mxnet_tpu.parallel import factor_devices
    for n in range(1, 17):
        for axes in (1, 2, 3):
            assert tmesh.factor_devices(n, axes) == factor_devices(n, axes)


@pytest.mark.parametrize("shape,span,want", [
    ("data=-1,model=2", "0", (["data", "model"], {"data": WORLD // 2,
                                                  "model": 2})),
    ("data=-1", "1", (["host", "data"], {"host": WORLD, "data": 1})),
])
def test_mesh_from_env(pool, shape, span, want):
    assert pool.run(cases.mesh_env, shape, span) == [want] * WORLD


@pytest.fixture
def mesh_env(monkeypatch):
    yield monkeypatch
    tmesh.refresh_from_env()


def test_mesh_from_env_unset_is_none(mesh_env):
    mesh_env.delenv("MXNET_MESH_SHAPE", raising=False)
    tmesh.refresh_from_env()
    assert tmesh.mesh_from_env() is None


def test_mesh_from_env_rejects_garbage(mesh_env):
    for bad in ("data:4", ",", "data=x"):
        mesh_env.setenv("MXNET_MESH_SHAPE", bad)
        with pytest.raises(ValueError):
            tmesh.refresh_from_env()
        with pytest.raises(ValueError):
            jmesh._parse_mesh_shape(bad)
    mesh_env.setenv("MXNET_MESH_SHAPE", "data=-1,model=2")
    tmesh.refresh_from_env()
    assert tmesh._ENV_SHAPE == jmesh._parse_mesh_shape("data=-1,model=2")


def test_default_mesh_precedence(pool):
    assert pool.run(cases.default_mesh_precedence) == \
        [(True, {"data": 2}, {"data": WORLD})] * WORLD


def test_filter_spec_drops_absent_axes(pool):
    jm = jmesh.make_mesh({"data": -1})
    want = (tuple(jmesh.filter_spec(P("data", "model", "seq"), jm)),
            tuple(jmesh.filter_spec(P("model"), jm)),
            tuple(jmesh.filter_spec(P("data"), None)))
    assert pool.run(cases.filter_spec) == [want] * WORLD


def test_named_sharding_and_shard_put_round_trip(pool):
    host = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    res = pool.run(cases.shard_put_round_trip, host)
    jm = jmesh.auto_mesh(("data", "model"), devices=jax.devices()[:WORLD])
    arr = jmesh.shard_put(host, jmesh.named_sharding(jm, P("data", "seq")))
    assert tuple(arr.sharding.spec) == res[0]["spec"] == ("data", None)
    for r in res:
        np.testing.assert_array_equal(r["whole"], host)
        np.testing.assert_array_equal(r["whole2"], host)
        np.testing.assert_array_equal(r["rep"], host)
        assert r["rep_spec"] == tuple(jmesh.replicated(jm).spec) == ()
    # each rank's block is the one its data coordinate names: the data
    # axis has 2 ranks, so ranks (0, 1) hold rows 0-3, ranks (2, 3) 4-7
    for r, res_r in enumerate(res):
        rows = slice(4 * (r // 2), 4 * (r // 2) + 4)
        np.testing.assert_array_equal(res_r["block"], host[rows])


def test_shard_map_psum(pool):
    out, x = pool.run(cases.shard_map_psum)[0]
    np.testing.assert_allclose(out, np.full_like(x, x.sum()))


def test_shard_map_uses_scope_mesh(pool):
    for out, raised in pool.run(cases.shard_map_scope):
        np.testing.assert_array_equal(out, [2.0])
        assert raised == "ValueError"


def _jax_collectives():
    """The JAX package's collectives over 4 devices and the gradients of
    ``sum(out * w)``, as ``{name: (out, grad)}``."""
    mesh = jmesh.make_mesh({"x": 4}, jax.devices()[:4])
    x = jnp.arange(4.0)
    w4 = jnp.arange(1.0, 5.0)
    w16 = jnp.arange(1.0, 17.0)
    fns = {
        "psum": (lambda s: jcol.psum(s, "x"), w4),
        "pmean": (lambda s: jcol.pmean(s, "x"), w4),
        "ppermute": (lambda s: jcol.ppermute_shift(s, "x", 1), w4),
        "ppermute_back": (lambda s: jcol.ppermute_shift(s, "x", -1), w4),
        "all_gather": (lambda s: jcol.all_gather(s, "x", axis=0), w16),
        "reduce_scatter": (lambda s: jcol.reduce_scatter(jnp.tile(s, 4),
                                                         "x"), w4),
        "all_to_all": (lambda s: jcol.all_to_all(
            jnp.tile(s, 4) * (jnp.arange(4.0) + 1), "x", 0, 0), w16),
    }
    out = {}
    for name, (f, w) in fns.items():
        g = jmesh.shard_map(f, mesh=mesh, in_specs=P("x"),
                            out_specs=P("x"), check=False)

        def loss(v, g=g, w=w):
            y = g(v)
            return jnp.sum(y * w), y
        (_, y), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(x)
        out[name] = (np.asarray(y), np.asarray(grad))
    return out


@pytest.fixture(scope="module")
def collectives(pool):
    x = np.arange(4.0, dtype=np.float32)
    return pool.run(cases.collectives, x,
                    np.arange(1.0, 17.0, dtype=np.float32)), _jax_collectives()


@pytest.mark.parametrize("name", ["psum", "pmean", "ppermute",
                                  "ppermute_back", "all_gather",
                                  "reduce_scatter", "all_to_all"])
def test_collective_and_gradient_equal_jax(collectives, name):
    ours, theirs = collectives
    for r in ours:
        out, grad = r[name]
        np.testing.assert_array_equal(out, theirs[name][0])
        np.testing.assert_array_equal(grad, theirs[name][1])


def test_collectives_shard_map(collectives):
    """``tests/test_parallel.py::test_collectives_shard_map``'s checks."""
    ours, _ = collectives
    x = np.arange(4.0)
    for r in ours:
        assert np.allclose(r["psum"][0], np.full(4, x.sum()))
        assert np.allclose(r["ppermute"][0], np.roll(x, 1))
        np.testing.assert_array_equal(r["all_gather"][0][:4], x)


def test_axis_queries_pmax_and_host_allreduce(collectives):
    ours, _ = collectives
    for i, r in enumerate(ours):
        assert r["pmax"] == 3.0
        assert (r["axis_index"], r["axis_size"]) == (i, 4)
        np.testing.assert_array_equal(r["host_allreduce"], [3.0, 3.0])
    want = jcol.host_allreduce([jnp.full((2,), float(k)) for k in range(3)])
    np.testing.assert_array_equal(ours[0]["host_allreduce"],
                                  np.asarray(want))


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    """Two ranks of an ``nccl`` group on a host with one card raise
    ``MXNetError`` before NCCL is asked (which would fail with "Duplicate
    GPU detected")."""
    monkeypatch.setenv("MXNET_NUM_PROCESSES", "2")
    monkeypatch.setenv("MXNET_PROCESS_ID", "0")
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_init(*a, **k):
        raise AssertionError("init_process_group must not be reached")
    monkeypatch.setattr(multihost.dist, "init_process_group", no_init)
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    with pytest.raises(MXNetError, match="share its 1 card"):
        multihost.init_from_env(device=torch.device("cuda", 0),
                                backend="nccl")
    with pytest.raises(MXNetError, match="share its 1 card"):
        multihost.init_from_env(device=torch.device("cuda", 0))


def test_init_from_env_single_process_is_a_no_op(monkeypatch):
    for name in ("MXNET_NUM_PROCESSES", "DMLC_NUM_WORKER"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.init_from_env(device="cpu") == (0, 1)
    assert multihost.rank() == 0 and multihost.num_processes() == 1
    assert multihost.host_gather_floats("x", 2.5) == [2.5]


def test_run_ranks_stops_a_rank_that_hangs():
    with pytest.raises(MXNetError, match=r"ranks \[1\] gave no result "
                                         r"within 2 s"):
        run_ranks(cases.hang, 2, timeout=2, args=(1,))


def test_pool_raises_with_the_failed_rank_traceback_and_restarts(pool):
    """A rank's exception stops the pool with that rank's traceback; the
    next call starts the ranks again.  (Last in the file: it restarts the
    file's pool.)"""
    starts = pool._starts
    with pytest.raises(MXNetError, match="(?s)failed on rank 1.*fails on "
                                         "purpose"):
        pool.run(cases.fail, 1)
    assert pool.run(cases.fail, 5) == list(range(WORLD))
    assert pool._starts == starts + 1


def test_parallel_exports_the_jax_package_names():
    """``mt.parallel`` has the JAX package's names but those of
    ``sharded.py`` (A.8's second part)."""
    import mxnet_tpu.parallel as jpar
    import mxnet_tpu_torch as mt
    later = {"ShardedTrainer", "block_pure_fn", "sharded_data"}
    missing = set(jpar.__all__) - later - set(mt.parallel.__all__)
    assert not missing
    assert all(hasattr(mt.parallel, n) for n in mt.parallel.__all__)


ZERO_CASES = [((8, 3), True, (8, 3)), ((8, 3), True, ()),
              ((5, 2), True, (5, 2)), ((8, 3), False, (8, 3)),
              ((), True, ()), ((12,), True, (12,))]


def test_zero_placement_matches_jax(pool):
    """``zero1_axis_mesh``, ``update_sharding`` and
    ``shard_state_tree_spec`` decide as the JAX package's on a 4-rank
    replica axis: which updates shard, and where each state leaf goes."""
    from mxnet_tpu.parallel import zero as jzero
    jm = jzero.zero1_axis_mesh(4, devices=jax.devices()[:4])
    rep = jmesh.replicated(jm)
    want = []
    for shape, replicated, leaf in ZERO_CASES:
        upd = jzero.update_sharding(jm, shape, "zero",
                                    P() if replicated else P("model"))
        place = jzero.shard_state_tree_spec(leaf, shape, upd, rep)
        want.append((upd is not None,
                     "update" if upd is not None and place is upd
                     else "replicated"))
    for res in pool.run(cases.zero_placement, ZERO_CASES):
        assert res["shape"] == {"zero": 4} == dict(jm.shape)
        assert [tuple(d) for d in res["decisions"]] == want
