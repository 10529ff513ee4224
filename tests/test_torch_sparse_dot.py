"""``dot`` with a CSR left operand against the JAX package on the CPU,
and the arithmetic of the ``csr_dot`` kernels held by their plain
versions and by models of their order.

The JAX package computes ``jnp.tensordot`` on the CSR's dense backing;
the port's CPU route gathers, multiplies and ``index_add_``s over the
parts.  The two sum in other orders, so each output is held relative to
its sum of |terms| (``|A| . |B|``): float32 within 1e-5, float64 within
1e-12, forward and B's gradient (``jax.vjp``).  The kernels' own orders
are modelled in numpy: the radix sort's placement (``radix_hist_kernel``,
``radix_prefix_kernel``, ``radix_scatter_kernel``) must be a stable sort by
column, and ``csr_t_dot_kernel`` with ``csr_t_dot_combine_kernel``, lane
for lane, must give ``t_dot_tiles_reference``'s sums bit for bit, which
equal the plain version's bit for bit in a column whose entries lie in
one tile of 32.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops.registry import get_op as jax_op

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, profiler
from mxnet_tpu_torch.ops import sparse_dot as sd

TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


def _ragged(rng, m, k, lengths, dtype=np.float64):
    """A dense (m, k) of ``lengths`` random entries a row (a length of k
    fills the row)."""
    dense = np.zeros((m, k), dtype)
    for r, n in enumerate(lengths):
        cols = rng.choice(k, size=n, replace=False)
        dense[r, cols] = rng.standard_normal(n)
    return dense


def _cases(rng):
    """(name, dense A): empty rows, nnz 0, a full row, the first and last
    columns, Zipf-skewed columns (long column segments)."""
    edge = np.zeros((9, 50))
    edge[:, 0] = rng.standard_normal(9)
    edge[::2, 49] = rng.standard_normal(5)
    skew = np.zeros((70, 40))
    for r in range(70):
        ids = np.unique(rng.zipf(1.5, 12) % 40)[:6]
        skew[r, ids] = rng.standard_normal(len(ids))
    return [("empty rows", _ragged(rng, 12, 30, [0, 3, 0, 0, 7, 1, 0, 0, 2,
                                                  0, 5, 0])),
            ("nnz 0", np.zeros((5, 8))),
            ("full row", _ragged(rng, 4, 33, [0, 33, 0, 2])),
            ("first and last columns", edge),
            ("skewed columns", skew)]


def _errors(got, want, scale):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    empty = scale == 0
    assert not diff[empty].any(), "an output without terms is not 0"
    return float((diff[~empty] / scale[~empty]).max()) if (~empty).any() \
        else 0.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("case", range(5))
def test_dot_csr_and_b_grad_match_jax_vjp(x64, dtype, transpose_a, case):
    rng = np.random.RandomState(100 + case)
    name, dense = _cases(rng)[case]
    dense = dense.astype(dtype)
    inner, outer = dense.shape[::-1] if not transpose_a else dense.shape
    n = 3
    b = rng.standard_normal((inner, n)).astype(dtype)
    og = rng.standard_normal((outer, n)).astype(dtype)
    a_t = mt.nd.csr_matrix(dense, dtype=dtype)
    b_t = mt.nd.array(b, dtype=dtype)
    b_t.attach_grad()
    before = profiler.counter(sd.DENSIFY_COUNTER)
    with mt.autograd.record():
        y = mt.nd.dot(a_t, b_t, transpose_a=transpose_a)
    y.backward(mt.nd.array(og, dtype=dtype))
    assert profiler.counter(sd.DENSIFY_COUNTER) == before
    dot = jax_op("dot").fn
    ref, vjp = jax.vjp(lambda x: dot(jax.numpy.asarray(dense), x,
                                     transpose_a=transpose_a), b)
    (ref_gb,) = vjp(og)
    a_abs = np.abs(dense.astype(np.float64))
    a_abs = a_abs.T if transpose_a else a_abs
    scale = a_abs @ np.abs(b.astype(np.float64))
    scale_gb = a_abs.T @ np.abs(og.astype(np.float64))
    assert y.dtype == np.dtype(dtype)
    assert _errors(y.asnumpy(), ref, scale) <= TOL[dtype], name
    assert _errors(b_t.grad.asnumpy(), ref_gb, scale_gb) <= TOL[dtype], name


@pytest.mark.parametrize("case", range(5))
def test_plain_versions_against_dense_products(case):
    """The plain versions never build A, and give A . B and A^T . G."""
    rng = np.random.RandomState(200 + case)
    _, dense = _cases(rng)[case]
    csr = mt.nd.csr_matrix(dense, dtype=np.float64)._parts()
    b = torch.from_numpy(rng.standard_normal((dense.shape[1], 4)))
    g = torch.from_numpy(rng.standard_normal((dense.shape[0], 4)))
    a = torch.from_numpy(dense)
    torch.testing.assert_close(sd.csr_dot_reference(csr, b), a @ b,
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(sd.csr_t_dot_reference(csr, g), a.T @ g,
                               rtol=1e-12, atol=1e-12)
    assert csr._dense is None


def _radix_model(keys, k):
    """``radix_hist_kernel``, ``radix_prefix_kernel`` and
    ``radix_scatter_kernel`` as the CUDA code computes them: 256 threads x
    8 chunks a block, ``sort_digits(k)`` passes; each entry at its (digit,
    block) offset
    plus the entries of its digit in earlier chunks, earlier warps and
    earlier lanes."""
    threads, warps, chunks = 256, 8, 8
    passes, digit = sd.sort_digits(k)
    radix = 1 << digit
    n = len(keys)
    vals = np.arange(n)
    blocks = -(-n // (threads * chunks))
    for shift in range(0, passes * digit, digit):
        hist = np.zeros((radix, blocks), np.int64)
        for i in range(n):
            hist[(keys[i] >> shift) & (radix - 1), i // (threads * chunks)] += 1
        flat = hist.reshape(-1)
        offsets = (np.cumsum(flat) - flat).reshape(radix, blocks)
        ko, vo = np.empty_like(keys), np.empty_like(vals)
        for blk in range(blocks):
            running = offsets[:, blk].copy()
            for ch in range(chunks):
                idx = blk * threads * chunks + ch * threads + np.arange(threads)
                dig = np.where(idx < n, (keys[np.minimum(idx, n - 1)] >> shift)
                               & (radix - 1), radix)
                count = np.stack([np.bincount(dig[w * 32:(w + 1) * 32],
                                              minlength=radix + 1)
                                  for w in range(warps)])
                for t in np.nonzero(idx < n)[0]:
                    w, lane = divmod(t, 32)
                    same = dig[w * 32:(w + 1) * 32] == dig[t]
                    rank = int(same[:lane].sum())
                    pos = running[dig[t]] + count[:w, dig[t]].sum() + rank
                    ko[pos], vo[pos] = keys[idx[t]], vals[idx[t]]
                running += count[:, :radix].sum(0)
        keys, vals = ko, vo
    return keys, vals


@pytest.mark.parametrize("n,k", [(1, 1), (300, 7), (4100, 1000001)])
def test_radix_sort_model_is_a_stable_sort(n, k):
    """The placement the sort kernels compute keeps equal columns in row
    order: it is ``transpose_parts_reference``'s stable argsort."""
    rng = np.random.RandomState(n)
    keys = (rng.zipf(1.5, n) % k).astype(np.int64)
    got_keys, got_perm = _radix_model(keys, k)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_perm, order)
    np.testing.assert_array_equal(got_keys, keys[order])
    indptr = torch.tensor([0, n])
    csr = sd.CSR(torch.ones(n), torch.from_numpy(keys), indptr, (1, k))
    ref_keys, perm, rows = sd.transpose_parts_reference(csr)
    np.testing.assert_array_equal(perm.numpy(), order)
    np.testing.assert_array_equal(ref_keys.numpy(), keys[order])
    assert not rows.any()
    assert sd.sort_digits(k) == {1: (1, 1), 7: (1, 3),
                                 1000001: (2, 10)}[k]


def _t_dot_warp_model(csr, g):
    """``csr_t_dot_kernel`` then ``csr_t_dot_combine_kernel`` as the CUDA
    code computes them, lane by lane: a tile of 32 sorted entries a warp,
    the lane that ends a run in a tile sums the run's products from its
    first lane in order and writes out, head or tail; the combine adds
    a run's tail and the heads of the tiles it reaches in tile order."""
    keys, perm, rows = (t.long() for t in sd.transpose_parts(csr))
    nnz, n = csr.nnz, g.shape[1]
    tiles = -(-nnz // 32)
    out = torch.zeros((csr.shape[1], n), dtype=g.dtype)
    head = torch.full((tiles, n), float("nan"), dtype=g.dtype)
    tail = head.clone()
    for t in range(tiles):
        j = t * 32 + np.arange(32)
        key = [int(keys[x]) if x < nnz else -1 for x in j]
        prev = [int(keys[j[0] - 1]) if j[0] > 0 else -1] + key[:-1]
        nxt = key[1:] + [int(keys[j[31] + 1]) if j[31] + 1 < nnz else -1]
        p = [csr.values[perm[x]] * g[rows[perm[x]]] if x < nnz
             else torch.zeros(n, dtype=g.dtype) for x in j]
        starts = [lane == 0 or key[lane] != prev[lane] for lane in range(32)]
        for lane in range(32):
            first = max(i for i in range(lane + 1) if starts[i])
            ends = j[lane] < nnz and (lane == 31 or key[lane] != nxt[lane])
            if not ends:
                continue
            acc = torch.zeros(n, dtype=g.dtype)
            for i in range(first, lane + 1):
                acc = acc + p[i]
            if first == 0 and key[0] == prev[0]:
                head[t] = acc
            elif key[lane] == nxt[lane]:
                tail[t] = acc
            else:
                out[key[lane]] = acc
    for t in range(tiles - 1):
        key = int(keys[t * 32 + 31])
        if int(keys[t * 32 + 32]) != key or \
                (t > 0 and int(keys[t * 32 - 1]) == key):
            continue
        total = tail[t]
        u = t + 1
        while u < tiles and int(keys[u * 32]) == key:
            total = total + head[u]
            u += 1
        out[key] = total
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_t_dot_block_order_model(dtype):
    """The kernels' order, lane for lane, is ``t_dot_tiles_reference``'s
    bit for bit; bit for bit with the plain version in columns whose
    entries lie in one tile of 32; within the tolerance in the others."""
    rng = np.random.RandomState(8)
    dense = np.zeros((100, 20))
    dense[:, 0] = rng.standard_normal(100)          # 100 entries: 4 tiles
    dense[:, 1] = rng.standard_normal(100) * 1e3
    dense[:31, 2] = rng.standard_normal(31)
    dense[::3, 5] = rng.standard_normal(34)
    dense[:2, 7] = rng.standard_normal(2)
    csr = mt.nd.csr_matrix(dense, dtype=np.float64)._parts()
    csr = sd.CSR(csr.values.to(dtype), csr.indices, csr.indptr, csr.shape)
    g = torch.from_numpy(rng.standard_normal((100, 2))).to(dtype)
    got = _t_dot_warp_model(csr, g)
    assert torch.equal(got, sd.t_dot_tiles_reference(csr, g))
    plain = sd.csr_t_dot_reference(csr, g)
    keys = sd.transpose_parts(csr)[0].long()
    tile = torch.arange(csr.nnz) // 32
    one_tile = [c for c in range(20)
                if tile[keys == c].unique().numel() <= 1]
    assert 0 not in one_tile and 1 not in one_tile and 7 in one_tile
    assert torch.equal(got[one_tile], plain[one_tile])
    scale = sd.csr_t_dot_reference(
        sd.CSR(csr.values.abs(), csr.indices, csr.indptr, csr.shape), g.abs())
    assert _errors(got.numpy(), plain.numpy(), scale.numpy()) \
        <= TOL[np.float32 if dtype == torch.float32 else np.float64]


@pytest.mark.parametrize("case", range(5))
def test_t_dot_tiles_reference_on_ragged_cases(case):
    """The kernels' order, lane for lane, on the ragged cases: equal to
    ``t_dot_tiles_reference`` bit for bit, and to A^T . G."""
    rng = np.random.RandomState(300 + case)
    _, dense = _cases(rng)[case]
    csr = mt.nd.csr_matrix(dense, dtype=np.float64)._parts()
    g = torch.from_numpy(rng.standard_normal((dense.shape[0], 3)))
    got = _t_dot_warp_model(csr, g)
    assert torch.equal(got, sd.t_dot_tiles_reference(csr, g))
    torch.testing.assert_close(got, torch.from_numpy(dense).T @ g,
                               rtol=1e-12, atol=1e-12)


def test_other_dtypes_read_the_dense_view():
    dense = np.array([[0, 1.5, 0], [2, 0, -1]], np.float16)
    a = mt.nd.csr_matrix(dense, dtype=np.float16)
    b = mt.nd.array(np.ones((3, 2), np.float16), dtype=np.float16)
    before = profiler.counter(sd.DENSIFY_COUNTER)
    y = mt.nd.dot(a, b)
    assert profiler.counter(sd.DENSIFY_COUNTER) == before + 1
    np.testing.assert_array_equal(y.asnumpy(), dense.astype(np.float32)
                                  @ np.ones((3, 2), np.float32))


def test_grad_of_the_csr_itself_is_dense(x64):
    """A CSR that takes a gradient goes through its dense view, and its
    gradient is the JAX package's dense one."""
    rng = np.random.RandomState(3)
    dense = _ragged(rng, 5, 7, [2, 0, 7, 1, 3], np.float32)
    b = rng.standard_normal((7, 2)).astype(np.float32)
    og = rng.standard_normal((5, 2)).astype(np.float32)
    a = mt.nd.csr_matrix(dense)
    a.attach_grad()
    with mt.autograd.record():
        y = mt.nd.dot(a, mt.nd.array(b))
    y.backward(mt.nd.array(og))
    ref = mx.nd.array(dense)
    ref.attach_grad()
    with mx.autograd.record():
        ry = mx.nd.dot(ref, mx.nd.array(b))
    ry.backward(mx.nd.array(og))
    np.testing.assert_allclose(a.grad.asnumpy(), ref.grad.asnumpy(),
                               rtol=1e-6, atol=1e-6)
    assert a.grad.stype == "default"


def test_a_csr_off_the_cpu_never_takes_the_plain_route():
    """Only a CPU CSR runs the plain versions; any other device launches
    the kernels or raises."""
    csr = sd.CSR(torch.ones(2, device="meta"),
                 torch.zeros(2, dtype=torch.int64, device="meta"),
                 torch.zeros(3, dtype=torch.int64, device="meta"), (2, 4))
    b = torch.ones((4, 2), device="meta")
    for fn, x in ((sd.csr_dot, b), (sd.csr_t_dot, torch.ones((2, 2),
                                                             device="meta"))):
        with pytest.raises(MXNetError):
            fn(csr, x)
    cpu_csr = mt.nd.csr_matrix(np.eye(2, 4, dtype=np.float32))._parts()
    with pytest.raises(MXNetError):
        sd.dot(cpu_csr, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_a_csr_off_the_cpu_of_another_dtype_raises(dtype):
    """Off the CPU, a CSR of a dtype the kernels do not take raises,
    naming the dtypes, and builds no dense view (at avazu-app's width it
    would be 32.8 GB)."""
    csr = sd.CSR(torch.ones(2, dtype=dtype, device="meta"),
                 torch.zeros(2, dtype=torch.int64, device="meta"),
                 torch.zeros(3, dtype=torch.int64, device="meta"),
                 (2, 1000001))
    b = torch.ones((1000001, 2), dtype=dtype, device="meta")
    before = profiler.counter(sd.DENSIFY_COUNTER)
    for transpose_a, x in ((False, b), (True, b[:2])):
        with pytest.raises(MXNetError, match=str(dtype)):
            sd.dot(csr, x, transpose_a=transpose_a)
    assert profiler.counter(sd.DENSIFY_COUNTER) == before
    assert csr._dense is None


def test_operand_dtypes_must_match():
    """A CSR and an operand of two dtypes raise, naming both."""
    a = mt.nd.csr_matrix(np.eye(2, 3, dtype=np.float32))._parts()
    with pytest.raises(MXNetError, match="float64"):
        sd.dot(a, torch.ones((3, 2), dtype=torch.float64))
