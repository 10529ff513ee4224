"""A CSR in buffers of a fixed capacity, and the CSR-fed steps captured.

A captured step reads its CSR input from buffers of a fixed capacity
(``ndarray.sparse``: values past nnz zero, column ids past it 0, the row
pointers exact), and every kernel reads nnz on the card.  On the CPU the
plain versions stand in for the kernels, so they must give the same bits
padded or not: ``csr_dot_reference``, ``csr_t_dot_reference``,
``transpose_parts_reference``, ``t_dot_tiles_reference``, ``dense()``,
``row_slice`` and ``entry_rows``, at nnz 0, 1, 31-33 (a tile's edge) and
with no padding at all.  Then the capacity policy (a power of two, doubled
when a batch outgrows it, one recapture, none for a batch that fits), and
the sparse linear step (``forward_backward`` + ``update``, with and
without a store) and the FM's ``_fit_step`` captured (``capture.
stand_in``), in fp64, against the JAX package within 1e-10 (phase 32b's
``SPARSE_PARITY_TOL``) and against their eager runs bit for bit.
"""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import capture, profiler
from mxnet_tpu_torch.ndarray.sparse import CSRNDArray
from mxnet_tpu_torch.ops import sparse_dot as sd

import chip_smoke as cs

PARITY_TOL = cs.SPARSE_PARITY_TOL


class StandInGraph:
    """``capture`` runs the stage once, ``replay`` runs it again."""
    warmup_runs = 0

    def __init__(self, device, pool, generators):
        pass

    @staticmethod
    def pool(device):
        return None

    def capture(self, fn):
        self._fn = fn
        self._outs = [o.detach() for o in fn()]
        return self._outs

    def replay(self):
        with torch.no_grad():
            for dst, src in zip(self._outs, self._fn()):
                dst.copy_(src)


@pytest.fixture(autouse=True)
def _cpu_one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    profiler.reset_counters()
    with mt.cpu():
        yield
    torch.set_num_threads(prev)


def _mode(mode):
    return capture.stand_in(StandInGraph) if mode == "captured" \
        else contextlib.nullcontext()


def _parts(rng, m, k, nnz):
    """Host (values, indices, indptr) of ``nnz`` entries over ``m`` rows
    (some empty, some long), sorted distinct columns below ``k``."""
    counts = np.zeros(m, np.int64)
    np.add.at(counts, rng.randint(0, max(m // 2, 1), nnz) * 2, 1)
    counts = np.minimum(counts, k)
    while counts.sum() < nnz:
        counts[np.argmin(counts)] += 1
    cols = [np.sort(rng.choice(k, c, replace=False)) for c in counts]
    indices = np.concatenate(cols + [np.zeros(0, np.int64)]).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return rng.randn(nnz), indices, indptr


def _pair(nnz, pad, dtype, m=12, k=40, seed=0):
    """(unpadded CSR, the same CSR in buffers of nnz + pad slots)."""
    values, indices, indptr = _parts(np.random.RandomState(seed + nnz), m,
                                     k, nnz)
    tight = sd.CSR(torch.tensor(values, dtype=dtype),
                   torch.from_numpy(indices), torch.from_numpy(indptr),
                   (m, k))
    padded = sd.CSR(torch.cat([tight.values, torch.zeros(pad, dtype=dtype)]),
                    torch.cat([tight.indices,
                               torch.zeros(pad, dtype=torch.int64)]),
                    tight.indptr.clone(), (m, k))
    return tight, padded


NNZ = [0, 1, 31, 32, 33, 64]
PADS = [0, 1, 31]
DTYPES = [torch.float32, torch.float64]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("nnz", NNZ)
def test_plain_versions_same_bits_padded(nnz, pad, dtype):
    tight, padded = _pair(nnz, pad, dtype)
    assert padded.capacity == nnz + pad and padded.nnz == nnz
    gen = torch.Generator().manual_seed(nnz + pad)
    b = torch.randn((40, 3), generator=gen, dtype=dtype)
    g = torch.randn((12, 3), generator=gen, dtype=dtype)
    for fn, operand in ((sd.csr_dot_reference, b),
                        (sd.csr_t_dot_reference, g),
                        (sd.t_dot_tiles_reference, g),
                        (sd.csr_dot, b), (sd.csr_t_dot, g)):
        assert torch.equal(fn(padded, operand), fn(tight, operand)), fn
    for a, c in zip(sd.transpose_parts_reference(padded),
                    sd.transpose_parts_reference(tight)):
        assert torch.equal(a, c)
    assert torch.equal(padded.dense(), tight.dense())
    assert padded.dense().shape == (12, 40)
    for start, stop in ((0, 12), (3, 9), (5, 5), (11, 12)):
        a, c = padded.row_slice(start, stop), tight.row_slice(start, stop)
        assert torch.equal(a.values, c.values)
        assert torch.equal(a.indices, c.indices)
        assert torch.equal(a.indptr, c.indptr)
    rows = sd.entry_rows(padded.indptr, padded.capacity)
    assert torch.equal(rows[:nnz], sd.entry_rows(tight.indptr, nnz))
    assert bool((rows[nnz:] == 12).all())
    trimmed = padded.trimmed()
    assert trimmed.capacity == nnz
    assert (tight.trimmed() is tight)


@pytest.mark.parametrize("nnz", NNZ)
def test_dense_view_matches_the_jax_package(nnz):
    """The padded CSR's dense view against the JAX package's dense backing
    of the same parts."""
    tight, padded = _pair(nnz, 7, torch.float64)
    ref = mx.nd.sparse.csr_matrix(
        (tight.values.numpy(), tight.indices.numpy(), tight.indptr.numpy()),
        shape=(12, 40), dtype=np.float64)
    np.testing.assert_array_equal(padded.dense().numpy(), ref.asnumpy())
    arr = CSRNDArray(padded, mt.cpu())
    np.testing.assert_array_equal(arr.asnumpy(), ref.asnumpy())
    np.testing.assert_array_equal(arr.indices.asnumpy(),
                                  ref.indices.asnumpy())
    np.testing.assert_array_equal(arr.data.asnumpy(), ref.data.asnumpy())


def _batch_csr(nnz, m=12, k=40, seed=1):
    values, indices, indptr = _parts(np.random.RandomState(seed), m, k, nnz)
    return sd.CSR(torch.tensor(values, dtype=torch.float32),
                  torch.from_numpy(indices), torch.from_numpy(indptr),
                  (m, k))


def test_capacity_policy():
    """The first batch sets a power of two; a batch that fits goes into
    the same buffers (values past nnz zero); one that does not doubles the
    capacity until it fits; the buffers stay under twice the largest
    batch."""
    bound = mt.nd.sparse.zeros("csr", (12, 40))
    held = []
    for nnz, cap, moved in ((5, 8, True), (8, 8, False), (3, 8, False),
                            (9, 16, True), (2, 16, False), (40, 64, True),
                            (17, 64, False)):
        before = bound._parts().values
        bound._set_data(_batch_csr(nnz))
        c = bound._parts()
        assert c.capacity == cap and c.nnz == nnz
        assert (c.values.data_ptr() != before.data_ptr()) == moved
        assert bool((c.values[nnz:] == 0).all())
        assert bool((c.indices[nnz:] == 0).all())
        np.testing.assert_array_equal(bound.asnumpy(),
                                      CSRNDArray(_batch_csr(nnz), mt.cpu())
                                      .asnumpy())
        held.append(nnz)
        assert c.capacity < 2 * max(held)


def _linear(pkg, dim):
    return cs.sparse_linear_symbol(pkg, dim, dtype="float64")


def _fp64_batches(pkg, n, m, dim, seed, nnz_range=(2, 9)):
    """``n`` fp64 batches of ``m`` rows at width ``dim`` (row lengths drawn
    in ``nnz_range``, so the batches' nnz goes up and down)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lengths = rng.randint(*nnz_range, size=m)
        cols = [np.sort(rng.choice(dim, c, replace=False)) for c in lengths]
        indices = np.concatenate(cols).astype(np.int64)
        indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
        values = rng.rand(indices.size) + 0.1
        labels = rng.randint(0, 2, m).astype(np.float64)
        data = pkg.nd.sparse.csr_matrix((values, indices, indptr),
                                        shape=(m, dim), dtype=np.float64)
        out.append(pkg.io.DataBatch([data], [pkg.nd.array(
            labels, dtype=np.float64)]))
    return out


def _descs(pkg, m, dim):
    return ([pkg.io.DataDesc("data", (m, dim), np.float64)],
            [pkg.io.DataDesc("softmax_label", (m,), np.float64)])


def _linear_run(pkg, batches, init, kv_kind, mode="eager", m=16, dim=50):
    params = ({k: pkg.nd.array(v, dtype=np.float64) for k, v in init.items()},
              {})
    kv = pkg.kv.create(kv_kind) if kv_kind else None
    mod = pkg.mod.Module(_linear(pkg, dim), data_names=["data"],
                         label_names=["softmax_label"], context=pkg.cpu())
    mod.bind(*_descs(pkg, m, dim))
    mod.set_params(*params)
    mod.init_optimizer(kvstore=kv, optimizer="sgd",
                       optimizer_params=cs.SPARSE_OPT)
    with _mode(mode):
        losses = [cs.sparse_linear_step(mod, b, kv) for b in batches]
    return losses, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("kv_kind", [None, "local"])
def test_sparse_linear_step_captured_fp64_against_jax(kv_kind):
    """Phase 32b's loop (``forward_backward`` + ``update``, a store's
    ``row_sparse_pull`` first) captured: one ``forward_backward`` replay a
    step, a capture only when a batch outgrows the capacity, bit for bit
    its eager run, and within 1e-10 of the JAX package's steps in fp64."""
    m, dim = 16, 50
    rng = np.random.RandomState(5)
    init = {"weight": rng.normal(0, 0.3, (dim, 2)), "bias": np.zeros(2)}
    mine = _fp64_batches(mt, 6, m, dim, 7)
    theirs = _fp64_batches(mx, 6, m, dim, 7)
    ref = _linear_run(mx, theirs, init, kv_kind)
    eager = _linear_run(mt, mine, init, kv_kind)
    profiler.reset_counters()
    captured = _linear_run(mt, mine, init, kv_kind, "captured")
    nnz = [b.data[0]._parts().nnz for b in mine]
    caps = [1 << (nnz[0] - 1).bit_length()]
    for n in nnz[1:]:
        caps.append(caps[-1] if n <= caps[-1] else 2 * caps[-1])
    assert profiler.counter("graph_replays") == len(mine)
    assert profiler.counter("graph_captures") == len(set(caps))
    np.testing.assert_array_equal(captured[0], eager[0])
    for k in init:
        np.testing.assert_array_equal(captured[1][k], eager[1][k])
        np.testing.assert_allclose(captured[1][k], ref[1][k], rtol=0,
                                   atol=PARITY_TOL)
    np.testing.assert_allclose(captured[0], ref[0], rtol=0, atol=PARITY_TOL)


def test_capacity_grows_once_and_replays_after():
    """The one-call step over batches whose nnz goes up and down: one
    capture for the first batch, one when a batch outgrows the capacity
    (the old program dropped), none after."""
    m, dim = 8, 30
    rng = np.random.RandomState(6)
    init = {"weight": rng.normal(0, 0.3, (dim, 2)), "bias": np.zeros(2)}
    batches = _fp64_batches(mt, 2, m, dim, 8, (1, 3)) \
        + _fp64_batches(mt, 4, m, dim, 9, (3, 5))
    mod = mt.mod.Module(_linear(mt, dim), data_names=["data"],
                        label_names=["softmax_label"], context=mt.cpu())
    mod.bind(*_descs(mt, m, dim))
    mod.set_params({k: mt.nd.array(v, dtype=np.float64)
                    for k, v in init.items()}, {})
    mod.init_optimizer(optimizer="sgd", optimizer_params=cs.SPARSE_OPT)
    caps = []
    with _mode("captured"):
        for b in batches:
            mod._fit_step(b)
            caps.append(mod._exec_group.execs[0].arg_dict["data"]._parts()
                        .capacity)
    nnz = [b.data[0]._parts().nnz for b in batches]
    assert all(n <= c < 2 * max(nnz[:i + 1])
               for i, (n, c) in enumerate(zip(nnz, caps)))
    assert profiler.counter("graph_captures") == len(set(caps)) == 2
    assert profiler.counter("graph_replays") == len(batches)
    assert len(mod._cached_step._programs) == 1


def _fm_run(pkg, batches, init, mode="eager", dim=30, factor=4):
    mod = pkg.mod.Module(cs.fm_symbol(pkg, dim, factor, "float64"),
                         data_names=["data"],
                         label_names=["softmax_label"], context=pkg.cpu())
    mod.bind(*_descs(pkg, 16, dim))
    mod.set_params({k: pkg.nd.array(v, dtype=np.float64)
                    for k, v in init.items()}, {})
    mod.init_optimizer(optimizer="adam",
                       optimizer_params=(("learning_rate", 0.05),))
    losses = []
    with _mode(mode):
        for b in batches:
            if pkg is mx:
                mod.forward_backward(b)
                mod.update()
            else:
                mod._fit_step(b)
            losses.append(float(mod.get_outputs()[0].asnumpy()))
    return losses, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_fm_fit_step_captured_fp64_against_jax():
    """The FM's ``_fit_step`` captured: one replay a step, no step left
    eager, its ``x * x`` read from a dense view built in the program on
    every replay (bit for bit its eager run), within 1e-10 of the JAX
    package's jitted steps in fp64."""
    dim, factor = 30, 4
    rng = np.random.RandomState(11)
    init = {"w": rng.normal(0, 0.1, (dim, 1)),
            "v": rng.normal(0, 0.1, (dim, factor)), "w0": np.zeros(1)}
    ref = _fm_run(mx, _fp64_batches(mx, 4, 16, dim, 12), init)
    mine = _fp64_batches(mt, 4, 16, dim, 12)
    eager = _fm_run(mt, mine, init)
    profiler.reset_counters()
    captured = _fm_run(mt, mine, init, "captured")
    assert profiler.counter("sparse_eager_steps") == 0
    assert profiler.counter("graph_replays") == len(mine)
    assert profiler.counter(sd.DENSIFY_COUNTER) >= 1
    np.testing.assert_array_equal(captured[0], eager[0])
    for k in init:
        np.testing.assert_array_equal(captured[1][k], eager[1][k])
        np.testing.assert_allclose(captured[1][k], ref[1][k], rtol=0,
                                   atol=PARITY_TOL)
    np.testing.assert_allclose(captured[0], ref[0], rtol=0, atol=PARITY_TOL)
