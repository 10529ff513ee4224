"""The kvstore against the JAX package's on the CPU, case for case with
``tests/test_kvstore.py``: each case runs in both packages on the same
numpy-seeded inputs, the per-context copies on ``cpu(0)``..``cpu(3)``.

Bars.  A sum of two copies is exact to one rounding in either package,
so values are held bit for bit; a sum of four copies may add in another
order (XLA's reduction against this package's), so it is held to one
unit in the last place, relative (``np.spacing`` of the larger value).
Bucket plans are held equal, and the counters each case reads equal the
reference's (``program_calls`` is the JAX package's
``xla_program_calls``).  The reference's ``Updater`` counts a program
for each update it runs and this package's does not, so cases with an
updater compare the kvstore's own counters only.
"""
import pickle

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import profiler as jax_prof

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, profiler as port_prof

SHAPE = (4, 4)
KEYS = [5, 7, 11]
KV_COUNTERS = ("kvstore_push", "kvstore_pull", "kvstore_bucket_reduce",
               "kvstore_reduce_scatter", "collective_chunk_programs")
PROGRAMS = {mt: "program_calls", mx: "xla_program_calls"}


def _counts(pkg, names):
    prof = port_prof if pkg is mt else jax_prof
    return {n: prof.counter(PROGRAMS[pkg] if n == "programs" else n)
            for n in names}


def _moved(pkg, fn, names=KV_COUNTERS + ("programs",)):
    """``fn()``'s result and what it moved of the counters ``names``."""
    before = _counts(pkg, names)
    out = fn()
    after = _counts(pkg, names)
    return out, {n: after[n] - before[n] for n in names}


def _arr(pkg, value, ctx=0, dtype="float32"):
    return pkg.nd.array(np.asarray(value), ctx=pkg.cpu(ctx), dtype=dtype)


def _init_kv(pkg, kind="local"):
    kv = pkg.kv.create(kind)
    kv.init(3, pkg.nd.zeros(SHAPE, ctx=pkg.cpu()))
    kv.init(KEYS, [pkg.nd.zeros(SHAPE, ctx=pkg.cpu())] * len(KEYS))
    return kv


def _both(case):
    """``case(pkg)`` in each package: (port's, reference's)."""
    return case(mt), case(mx)


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_single_kv_pair():
    def case(pkg):
        kv = _init_kv(pkg)
        kv.push(3, _arr(pkg, np.ones(SHAPE) * 4))
        out = pkg.nd.empty(SHAPE, ctx=pkg.cpu())
        kv.pull(3, out=out)
        return out.asnumpy()
    port, ref = _both(case)
    _same([port], [ref])
    np.testing.assert_array_equal(port, np.ones(SHAPE) * 4)


@pytest.mark.parametrize("num_devs", [2, 4])
def test_aggregator_multiple_devs(num_devs):
    """Copies on ``cpu(0)``..``cpu(n-1)`` are summed: two bit for bit,
    four to one ulp; the same counters."""
    rng = np.random.RandomState(num_devs)
    single = rng.randn(num_devs, *SHAPE).astype(np.float32)
    multi = rng.randn(len(KEYS), num_devs, *SHAPE).astype(np.float32)

    def case(pkg):
        kv = _init_kv(pkg)

        def run():
            kv.push(3, [_arr(pkg, single[d], d) for d in range(num_devs)])
            out = pkg.nd.empty(SHAPE, ctx=pkg.cpu())
            kv.pull(3, out=out)
            kv.push(KEYS, [[_arr(pkg, multi[k, d], d)
                            for d in range(num_devs)]
                           for k in range(len(KEYS))])
            outs = [pkg.nd.empty(SHAPE, ctx=pkg.cpu()) for _ in KEYS]
            kv.pull(KEYS, out=outs)
            return [out.asnumpy()] + [o.asnumpy() for o in outs]
        return _moved(pkg, run)
    (port, port_n), (ref, ref_n) = _both(case)
    assert port_n == ref_n
    for a, b in zip(port, ref):
        if num_devs == 2:
            np.testing.assert_array_equal(a, b)
        else:
            assert np.all(np.abs(a - b) <= np.spacing(np.maximum(
                np.abs(a), np.abs(b))))
    np.testing.assert_allclose(port[0], single.sum(0), rtol=1e-6)


def test_updater_runs_on_push():
    def case(pkg):
        kv = _init_kv(pkg)
        updates = []

        def updater(key, grad, weight):
            updates.append(key)
            weight += grad * 2  # noqa: PLW2901

        kv.set_updater(updater)
        kv.push(3, _arr(pkg, np.ones(SHAPE)))
        out = pkg.nd.empty(SHAPE, ctx=pkg.cpu())
        kv.pull(3, out=out)
        return out.asnumpy(), updates
    port, ref = _both(case)
    _same([port[0]], [ref[0]])
    np.testing.assert_array_equal(port[0], np.ones(SHAPE) * 2)
    assert port[1] == ref[1] == [3]


@pytest.mark.parametrize("num_devs", [1, 2])
def test_set_optimizer_update_on_kvstore(num_devs):
    """The optimizer on the store: the update of the summed gradient
    (w = 0 - lr * sum), bit for bit as the reference's."""
    def case(pkg):
        kv = _init_kv(pkg)
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1,
                                           rescale_grad=1.0, wd=0.0))
        kv.push(3, [_arr(pkg, np.ones(SHAPE), d) for d in range(num_devs)])
        out = pkg.nd.empty(SHAPE, ctx=pkg.cpu())
        kv.pull(3, out=out)
        return out.asnumpy()
    port, ref = _both(case)
    _same([port], [ref])
    np.testing.assert_allclose(port, np.full(SHAPE, -0.1 * num_devs),
                               rtol=1e-5)


def test_row_sparse_pull():
    w = np.random.RandomState(1).randn(6, 3).astype(np.float32)

    def case(pkg):
        kv = pkg.kv.create("local")
        kv.init("w", _arr(pkg, w))
        out = pkg.nd.zeros((6, 3), ctx=pkg.cpu())
        rows = pkg.nd.array(np.array([1, 4], dtype=np.int64), ctx=pkg.cpu(),
                            dtype="int64")
        kv.row_sparse_pull("w", out=out, row_ids=rows)
        return out.asnumpy()
    port, ref = _both(case)
    _same([port], [ref])
    expect = np.zeros_like(w)
    expect[[1, 4]] = w[[1, 4]]
    np.testing.assert_array_equal(port, expect)


def test_get_type_rank(monkeypatch):
    """``type``, ``rank`` and ``num_workers``; ``create``'s names: the
    in-process kinds, ``dist_*`` without a launcher as a local store,
    and the refusals (a launched ``dist_*`` names A.10, ``tpu``, an
    unknown name, a name that is not a string)."""
    monkeypatch.delenv("DMLC_ROLE", raising=False)
    for kind in ("local", "device", "local_allreduce_cpu",
                 "local_allreduce_device", "dist_sync", "dist_async",
                 "dist_device_sync"):
        kvs = [pkg.kv.create(kind) for pkg in (mt, mx)]
        for kv in kvs:
            assert (kv.type, kv.rank, kv.num_workers) == (kind, 0, 1)
        assert kvs[0].get_num_dead_node() == kvs[1].get_num_dead_node() == 0
    for name in ("nccl", "horovod"):
        for pkg in (mt, mx):
            with pytest.raises(pkg.base.MXNetError,
                               match="unknown kvstore type"):
                pkg.kv.create(name)
    with pytest.raises(TypeError):
        mt.kv.create(3)
    with pytest.raises(MXNetError, match="no TPU"):
        mt.kv.create("tpu")
    monkeypatch.setenv("DMLC_ROLE", "worker")
    with pytest.raises(MXNetError, match="A.10"):
        mt.kv.create("dist_sync")
    with pytest.raises(NotImplementedError):
        mt.kv.create("local").set_gradient_compression({"type": "2bit"})
    kv = mt.kv.create("local")
    kv.init(0, mt.nd.zeros(SHAPE, ctx=mt.cpu()))
    with pytest.raises(MXNetError, match="already initialized"):
        kv.init(0, mt.nd.zeros(SHAPE, ctx=mt.cpu()))
    with pytest.raises(MXNetError, match="not initialized"):
        kv.push(1, mt.nd.zeros(SHAPE, ctx=mt.cpu()))


def test_optimizer_states_roundtrip(tmp_path):
    """The store's momenta through ``save_optimizer_states`` and back, and
    across packages (with and without the optimizer dumped): a store that
    holds the other package's weight and loads its file reads the momenta
    bit for bit, and its next update agrees with the other package's to
    two ulp: the weight and the momentum each round once a step, and
    each package may fuse a multiply-add where the other rounds twice."""
    g = np.random.RandomState(2).randn(*SHAPE).astype(np.float32)

    def first_step(pkg, dump):
        kv = _init_kv(pkg)
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9))
        kv.push(3, _arr(pkg, g))
        fname = str(tmp_path / ("%s-%d.states" % (pkg.__name__, dump)))
        kv.save_optimizer_states(fname, dump_optimizer=dump)
        kv.load_optimizer_states(fname)
        out = pkg.nd.empty(SHAPE, ctx=pkg.cpu())
        kv.pull(3, out=out)
        return kv, fname, out.asnumpy()

    def next_step(pkg, kv):
        kv.push(3, _arr(pkg, g))
        out = pkg.nd.empty(SHAPE, ctx=pkg.cpu())
        kv.pull(3, out=out)
        return out.asnumpy()

    for dump in (False, True):
        done = {pkg: first_step(pkg, dump) for pkg in (mt, mx)}
        for pkg, other in ((mt, mx), (mx, mt)):
            kv_o, f_o, w_o = done[other]
            kv = pkg.kv.create("local")
            kv.init(3, _arr(pkg, w_o))
            kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1,
                                               momentum=0.9))
            kv.load_optimizer_states(f_o)
            with open(f_o, "rb") as fh:
                payload = pickle.loads(fh.read())
            np.testing.assert_array_equal(
                kv._updater.states[3].asnumpy(),
                (payload[0] if dump else payload)[3].asnumpy())
            if dump:
                assert type(kv._updater.optimizer).__name__ == "SGD"
                assert kv._updater.optimizer.__module__ == pkg.__name__ \
                    + ".optimizer"
            got, want = next_step(pkg, kv), next_step(other, kv_o)
            assert np.all(np.abs(got - want) <= 2 * np.spacing(
                np.maximum(np.abs(got), np.abs(want))))
    kv_p = done[mt][0]
    blob = kv_p.get_checkpoint_state()
    fresh = _init_kv(mt)
    fresh.set_optimizer(mt.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    fresh.set_checkpoint_state(blob)
    assert fresh._updater.optimizer.num_update \
        == kv_p._updater.optimizer.num_update == 2
    assert fresh._updater.optimizer._index_update_count == {3: 2}


# -- the bucketed round -------------------------------------------------------
def test_plan_buckets_dtype_homogeneous_and_capped():
    from mxnet_tpu.kvstore import _plan_buckets as ref_plan
    from mxnet_tpu_torch.kvstore import _plan_buckets
    f, h = "float32", "float16"
    metas = [(f, 100), (f, 100), (h, 50), (f, 300), (h, 50), (f, 100)]
    plan = _plan_buckets(metas, limit=250)
    assert plan == ref_plan(metas, limit=250)
    for bucket in plan:
        assert len({metas[i][0] for i in bucket}) == 1
        assert sum(metas[i][1] for i in bucket) <= 250 or len(bucket) == 1
    assert sorted(i for b in plan for i in b) == list(range(len(metas)))
    assert [3] in plan
    rng = np.random.RandomState(0)
    for _ in range(20):
        metas = [(str(rng.choice(["a", "b", "c"])), int(rng.randint(1, 400)))
                 for _ in range(int(rng.randint(1, 30)))]
        for limit in (None, 64, 500):
            assert _plan_buckets(metas, limit) == ref_plan(metas, limit)


def _copies(seed, shapes, n, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [[rng.randn(*s).astype(dtype) for _ in range(n)] for s in shapes]


def test_push_pull_all_matches_per_key():
    """The bucketed round equals the per-key one bit for bit, in each
    package, and the two packages agree (three copies on three contexts:
    to one ulp)."""
    shapes = [(4, 4), (3,), (2, 5), (7,), (1, 1)]
    copies = _copies(0, shapes, 3)

    def case(pkg):
        kv_a, kv_b = pkg.kv.create("device"), pkg.kv.create("device")
        keys = list(range(len(shapes)))
        for k, s in zip(keys, shapes):
            kv_a.init(k, pkg.nd.zeros(s, ctx=pkg.cpu()))
            kv_b.init(k, pkg.nd.zeros(s, ctx=pkg.cpu()))
        outs_a = []
        for k, cps in zip(keys, copies):
            kv_a.push(k, [_arr(pkg, c, d) for d, c in enumerate(cps)])
            out = pkg.nd.empty(shapes[k], ctx=pkg.cpu())
            kv_a.pull(k, out=out)
            outs_a.append(out.asnumpy())
        reduced = kv_b.push_pull_all(
            keys, [[_arr(pkg, c, d) for d, c in enumerate(cps)]
                   for cps in copies])
        return outs_a, [r.asnumpy() for r in reduced]
    port, ref = _both(case)
    for outs_a, reduced in (port, ref):
        _same(outs_a, reduced)
    for a, b in zip(port[1], ref[1]):
        assert np.all(np.abs(a - b) <= np.spacing(np.maximum(np.abs(a),
                                                             np.abs(b))))


def test_push_pull_all_issues_one_program_per_bucket():
    rng = np.random.RandomState(1)
    vals = [[rng.randn(8, 8).astype(np.float32) for _ in range(2)]
            for _ in range(24)]

    def case(pkg):
        kv = pkg.kv.create("device")
        keys = list(range(24))
        for k in keys:
            kv.init(k, pkg.nd.zeros((8, 8), ctx=pkg.cpu()))
        return _moved(pkg, lambda: [r.asnumpy() for r in kv.push_pull_all(
            keys, [[_arr(pkg, c, d) for d, c in enumerate(v)]
                   for v in vals])])
    (port, port_n), (ref, ref_n) = _both(case)
    assert port_n == ref_n
    assert port_n["kvstore_bucket_reduce"] == 1
    _same(port, ref)


def test_push_pull_all_single_copy_is_identity():
    def case(pkg):
        kv = pkg.kv.create("device")
        kv.init(0, pkg.nd.zeros(SHAPE, ctx=pkg.cpu()))
        g = pkg.nd.ones(SHAPE, ctx=pkg.cpu()) * 3
        (out,), moved = _moved(pkg, lambda: kv.push_pull_all([0], [[g]]))
        return out is g, moved
    port, ref = _both(case)
    assert port == ref
    assert port[0] and port[1]["kvstore_bucket_reduce"] == 0


def test_program_call_accounting_symmetry():
    """Push and pull book their programs as the reference's do: one a
    reduce of several copies, none for one copy, one a destination."""
    def case(pkg):
        kv = _init_kv(pkg)
        moved = []
        for run in (
                lambda: kv.push(3, [pkg.nd.ones(SHAPE, ctx=pkg.cpu(d))
                                    for d in range(4)]),
                lambda: kv.push(3, pkg.nd.ones(SHAPE, ctx=pkg.cpu())),
                lambda: kv.pull(3, out=pkg.nd.empty(SHAPE, ctx=pkg.cpu())),
                lambda: kv.pull(3, out=[pkg.nd.empty(SHAPE, ctx=pkg.cpu(d))
                                        for d in range(2)]),
                lambda: kv.pull_all(KEYS, [pkg.nd.empty(SHAPE, ctx=pkg.cpu())
                                           for _ in KEYS])):
            moved.append(_moved(pkg, run)[1])
        return moved
    port, ref = _both(case)
    assert port == ref
    assert [m["programs"] for m in port] == [1, 0, 1, 2, len(KEYS)]


def test_push_pull_all_outs_accounting():
    def case(pkg):
        kv = pkg.kv.create("device")
        keys = list(range(4))
        for k in keys:
            kv.init(k, pkg.nd.zeros(SHAPE, ctx=pkg.cpu()))

        def vals():
            return [[pkg.nd.ones(SHAPE, ctx=pkg.cpu(d)) for d in range(2)]
                    for _ in keys]
        outs = [pkg.nd.empty(SHAPE, ctx=pkg.cpu()) for _ in keys]
        return [_moved(pkg, lambda: kv.push_pull_all(keys, vals()))[1],
                _moved(pkg, lambda: kv.push_pull_all(keys, vals(),
                                                     outs=outs))[1],
                [o.asnumpy() for o in outs]]
    port, ref = _both(case)
    assert port[:2] == ref[:2]
    assert [m["programs"] for m in port[:2]] == [1, 1 + 4]
    _same(port[2], ref[2])


def test_oversize_single_tensor_bucket_reduces_chunked_bitwise(monkeypatch):
    """A bucket of one tensor over the chunk budget sums chunk by chunk:
    as many chunk programs as the reference, bit for bit with the per-key
    sum, the uneven tail kept."""
    from mxnet_tpu.parallel import collective as ref_coll
    from mxnet_tpu_torch.parallel import collective
    monkeypatch.setenv("MXNET_OVERLAP_CHUNK_BYTES", "4096")
    collective.refresh_from_env()
    ref_coll.refresh_from_env()
    shape = (2473, 3)
    copies = _copies(7, [shape], 3)[0]
    try:
        def case(pkg):
            kv_a = pkg.kv.create("device")
            kv_a.init("big", pkg.nd.zeros(shape, ctx=pkg.cpu()))
            kv_a.push("big", [_arr(pkg, c, d) for d, c in enumerate(copies)])
            oracle = pkg.nd.empty(shape, ctx=pkg.cpu())
            kv_a.pull("big", out=oracle)
            kv_b = pkg.kv.create("device")
            kv_b.init("big", pkg.nd.zeros(shape, ctx=pkg.cpu()))
            (out,), moved = _moved(pkg, lambda: kv_b.push_pull_all(
                ["big"], [[_arr(pkg, c, d) for d, c in enumerate(copies)]]))
            return oracle.asnumpy(), out.asnumpy(), out.shape, moved
        port, ref = _both(case)
    finally:
        monkeypatch.delenv("MXNET_OVERLAP_CHUNK_BYTES")
        collective.refresh_from_env()
        ref_coll.refresh_from_env()
    assert port[3] == ref[3]
    assert port[3]["collective_chunk_programs"] == 8
    _same([port[0]], [port[1]])
    assert port[2] == shape
    assert np.all(np.abs(port[1] - ref[1]) <= np.spacing(np.maximum(
        np.abs(port[1]), np.abs(ref[1]))))


def test_reduce_scatter_all_uneven_tails_and_mixed_dtype():
    """The reduce-scatter leg over 4 contexts: mixed dtypes and an
    indivisible leading dim (left whole, as the reference's replicated
    fallback), each result equal to the per-key sum bit for bit and to
    the reference's; ``all_gather_all`` joins the row blocks home."""
    import jax
    from mxnet_tpu.parallel import zero as z
    from mxnet_tpu_torch.parallel.zero import zero1_update_spec
    if jax.local_device_count() < 4:
        pytest.skip("the reference needs 4 local devices")
    shapes = [(8, 3), (10, 3), (5,), (8, 2), (6, 2)]
    dtypes = [np.float32, np.float32, np.float32, np.float16, np.float16]
    rng = np.random.RandomState(11)
    copies = [[(rng.randn(*s) * 0.1).astype(dt) for _ in range(2)]
              for s, dt in zip(shapes, dtypes)]
    mesh = z.zero1_axis_mesh(4, "zero")

    def case(pkg):
        if pkg is mt:
            ctxs = [mt.cpu(i) for i in range(4)]
            shardings = [ctxs if zero1_update_spec(s, True, 4) else None
                         for s in shapes]
        else:
            shardings = [z.update_sharding(mesh, s, "zero") for s in shapes]
        kv, kv_o = pkg.kv.create("device"), pkg.kv.create("device")
        keys = list(range(len(shapes)))
        for k, s, dt in zip(keys, shapes, dtypes):
            kv.init(k, pkg.nd.zeros(s, ctx=pkg.cpu(), dtype=dt))
            kv_o.init(k, pkg.nd.zeros(s, ctx=pkg.cpu(), dtype=dt))

        def vals():
            return [[_arr(pkg, c, d, c.dtype) for d, c in enumerate(cps)]
                    for cps in copies]
        results, moved = _moved(pkg, lambda: kv.reduce_scatter_all(
            keys, vals(), shardings))
        oracle = []
        for k, v, s, dt in zip(keys, vals(), shapes, dtypes):
            kv_o.push(k, v)
            out = pkg.nd.empty(s, ctx=pkg.cpu(), dtype=dt)
            kv_o.pull(k, out=out)
            oracle.append(out.asnumpy())
        gathered = kv.all_gather_all(keys, results)
        return ([np.asarray(r.asnumpy()) for r in results], oracle,
                [g.asnumpy() for g in gathered], shardings, moved)
    port, ref = _both(case)
    assert [s is None for s in port[3]] == [s is None for s in ref[3]] \
        == [False, True, True, False, True]
    assert port[4]["kvstore_reduce_scatter"] == \
        ref[4]["kvstore_reduce_scatter"] == 1
    assert port[4]["kvstore_bucket_reduce"] == ref[4]["kvstore_bucket_reduce"]
    for got, oracle, gathered, want, s, dt in zip(port[0], port[1], port[2],
                                                  ref[0], shapes, dtypes):
        assert got.shape == gathered.shape == tuple(s)
        assert got.dtype == np.dtype(dt)
        np.testing.assert_array_equal(got, oracle)
        np.testing.assert_array_equal(gathered, oracle)
        np.testing.assert_array_equal(got, want)


def test_push_all_runs_updater_per_key():
    def case(pkg):
        kv = _init_kv(pkg)
        seen = []

        def updater(key, grad, weight):
            seen.append(key)
            weight += grad  # noqa: PLW2901

        kv.set_updater(updater)
        _, moved = _moved(pkg, lambda: kv.push_all(
            KEYS, [[pkg.nd.ones(SHAPE, ctx=pkg.cpu(d)) for d in range(2)]
                   for _ in KEYS]), KV_COUNTERS)
        outs = [pkg.nd.empty(SHAPE, ctx=pkg.cpu()) for _ in KEYS]
        kv.pull_all(KEYS, outs)
        return [o.asnumpy() for o in outs], sorted(seen), moved
    port, ref = _both(case)
    _same(port[0], ref[0])
    for o in port[0]:
        np.testing.assert_array_equal(o, np.ones(SHAPE) * 2)
    assert port[1] == ref[1] == sorted(KEYS)
    assert port[2] == ref[2]
