"""Sparse NDArrays against the JAX package on the CPU: every sparse case
of ``tests/test_ndarray.py`` and ``tests/test_kvstore.py``, case for case
in both packages, then ``cast_storage``, ``sparse_retain``, the random
sparse arrays, the storage tag through pickles, ``nd.save`` and
``params_from_jax``, ``sym.var(stype=)`` and the executor's binding, and a
CSR of width 10^7 that builds no dense matrix.

Values are held bit for bit: the sparse arrays hold what the JAX
package's dense backing holds (float32 both), and the ops here copy or
select; only the dense product of ``test_wide_csr_builds_no_dense`` sums,
in the same order on both routes.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.test_utils  # noqa: F401  (mx.test_utils)
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, profiler
from mxnet_tpu_torch.ndarray import sparse as psp
from mxnet_tpu_torch.ops import sparse_dot as sd


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


def _both(case):
    """``case(pkg)`` in each package: (port's, reference's)."""
    return case(mt), case(mx)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _densify():
    return profiler.counter(sd.DENSIFY_COUNTER)


def test_sparse_row_sparse():
    def case(pkg):
        rsp = pkg.nd.row_sparse_array(([[1., 2.], [3., 4.]], [0, 2]),
                                      shape=(4, 2))
        dense = rsp.tostype("default")
        return (rsp.stype, rsp.indices.asnumpy(), rsp.data.asnumpy(),
                dense.stype, dense.asnumpy())
    port, ref = _both(case)
    assert port[0] == ref[0] == "row_sparse"
    assert port[3] == ref[3] == "default"
    for a, b in zip(port[1:], ref[1:]):
        if not isinstance(a, str):
            _eq(a, b)
    _eq(port[4], [[1, 2], [0, 0], [3, 4], [0, 0]])


def test_sparse_csr():
    def case(pkg):
        m = pkg.nd.csr_matrix(([1., 2., 3.], [0, 2, 1], [0, 2, 3]),
                              shape=(2, 3))
        return m.stype, m.asnumpy(), m.indptr.asnumpy(), m.indices.asnumpy()
    port, ref = _both(case)
    assert port[0] == ref[0] == "csr"
    for a, b in zip(port[1:], ref[1:]):
        _eq(a, b)
    _eq(port[1], [[1, 0, 2], [0, 3, 0]])


def test_row_sparse_metadata_device_path():
    """Seeded by the constructor, dropped by a write, recomputed as the
    rows that are not zero."""
    def case(pkg):
        r = pkg.nd.sparse.row_sparse_array(
            (np.full((2, 3), 5.0, np.float32), [1, 4]), shape=(6, 3))
        got = [r.indices.asnumpy(), r.data.asnumpy()]
        r[:] = r * 3
        got += [r.indices.asnumpy(), r.data.asnumpy()]
        r[0, 0] = 1.0
        got += [r.indices.asnumpy(), r.data.asnumpy(), r.asnumpy()]
        return got
    port, ref = _both(case)
    for a, b in zip(port, ref):
        _eq(a, b)
    _eq(port[4], [0, 1, 4])


def test_kvstore_row_sparse_pull_seeds_metadata():
    def case(pkg):
        kv = pkg.kv.create("local")
        kv.init("w", pkg.nd.array(np.arange(12, dtype=np.float32)
                                  .reshape(6, 2)))
        out = pkg.nd.sparse.zeros("row_sparse", (6, 2))
        kv.row_sparse_pull("w", out=out, row_ids=pkg.nd.array(
            np.array([1, 3], np.int64), dtype="int64"))
        return (out.stype, out.indices.asnumpy(), out.data.asnumpy(),
                out.asnumpy())
    port, ref = _both(case)
    assert port[0] == ref[0] == "row_sparse"
    for a, b in zip(port[1:], ref[1:]):
        _eq(a, b)
    _eq(port[1], [1, 3])


def test_csr_metadata_seeded_and_invalidated():
    data = np.array([1.0, 2.0, 3.0], np.float32)
    indices = np.array([0, 2, 1], np.int64)
    indptr = np.array([0, 2, 2, 3], np.int64)

    def case(pkg):
        m = pkg.nd.sparse.csr_matrix((data, indices, indptr), shape=(3, 4))
        got = [m.indices.asnumpy(), m.indptr.asnumpy(), m.data.asnumpy(),
               m.asnumpy()]
        m[:] = m * 0 + np.array([[0, 5, 0, 0]] * 3, np.float32)
        got += [m.indices.asnumpy(), m.indptr.asnumpy(), m.data.asnumpy(),
                m.asnumpy()]
        return got
    port, ref = _both(case)
    for a, b in zip(port, ref):
        _eq(a, b)
    _eq(port[0], indices)
    _eq(port[4], [1, 1, 1])
    _eq(port[5], [0, 1, 2, 3])


def test_csr_constructor_edge_cases():
    """Given parts are copied; repeated columns sum; non-canonical parts
    come back canonical."""
    def case(pkg):
        d = np.array([1.0, 2.0, 3.0], np.float32)
        m = pkg.nd.sparse.csr_matrix((d, [0, 1, 2], [0, 1, 2, 3]),
                                     shape=(3, 3))
        d[0] = 99.0
        dup = pkg.nd.sparse.csr_matrix(
            (np.array([1.0, 2.0], np.float32), [0, 0], [0, 2, 2]),
            shape=(2, 3))
        unsorted = pkg.nd.sparse.csr_matrix(
            (np.array([1.0, 0.0, 2.0, -2.0, 4.0], np.float32),
             [2, 0, 1, 1, 0], [0, 3, 5]), shape=(2, 3))
        kept_zero = pkg.nd.sparse.csr_matrix(
            (np.array([0.0, 7.0], np.float32), [0, 2], [0, 2]), shape=(1, 3))
        return [x for a in (m, dup, unsorted, kept_zero)
                for x in (a.data.asnumpy(), a.indices.asnumpy(),
                          a.indptr.asnumpy(), a.asnumpy())]
    port, ref = _both(case)
    for a, b in zip(port, ref):
        _eq(a, b)
    _eq(port[0], [1.0, 2.0, 3.0])
    _eq(port[4], [3.0])


def test_row_sparse_pull():
    """``tests/test_kvstore.py::test_row_sparse_pull``: into a dense
    output, written in place and tagged."""
    w = np.random.RandomState(7).randn(6, 3).astype(np.float32)

    def case(pkg):
        kv = pkg.kv.create("local")
        kv.init("w", pkg.nd.array(w))
        out = pkg.nd.zeros((6, 3))
        held = out._data
        kv.row_sparse_pull("w", out=out, row_ids=pkg.nd.array(
            np.array([1, 4], dtype=np.int64), dtype="int64"))
        return out.asnumpy(), out.stype, out._data is held
    port, ref = _both(case)
    expect = np.zeros_like(w)
    expect[[1, 4]] = w[[1, 4]]
    _eq(port[0], ref[0])
    _eq(port[0], expect)
    assert port[1] == ref[1] == "row_sparse"
    assert port[2], "the port writes into the output's own tensor"


@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
@pytest.mark.parametrize("shape,density", [((9, 7), 0.3), ((16, 5), 0.0),
                                           ((4, 11), 1.0)])
def test_cast_storage_and_retain_on_random_arrays(stype, shape, density):
    """``rand_sparse_ndarray`` draws the JAX package's arrays from the same
    stream; ``cast_storage`` to every type and back, the op form and
    ``sparse_retain`` give the JAX package's values and tags."""
    def case(pkg):
        pkg.random.seed(11)
        arr, dense = pkg.test_utils.rand_sparse_ndarray(shape, stype,
                                                        density=density)
        got = [dense, arr.asnumpy(), arr.stype]
        for to in ("default", "row_sparse", "csr"):
            c = pkg.nd.sparse.cast_storage(arr, to)
            got += [c.stype, c.asnumpy(), c.tostype(stype).asnumpy()]
        op = pkg.nd.cast_storage(arr, stype="default")
        got += [op.stype, op.asnumpy()]
        keep = pkg.nd.array(np.array([0, 2, 3], np.int64), dtype="int64")
        for fn in (pkg.nd.sparse_retain, pkg.nd._internal._sparse_retain):
            r = fn(arr.tostype("default"), keep)
            got += [r.stype, r.asnumpy()]
        if stype == "row_sparse":
            r = arr.retain(keep)
            got += [r.stype, r.asnumpy(), arr.indices.asnumpy(),
                    arr.data.asnumpy()]
        else:
            got += [arr.indices.asnumpy(), arr.indptr.asnumpy(),
                    arr.data.asnumpy()]
        return got
    port, ref = _both(case)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        if isinstance(a, str):
            assert a == b
        else:
            _eq(a, b)


def test_rand_ndarray_draws_as_the_jax_package():
    def case(pkg):
        pkg.random.seed(5)
        out = [pkg.test_utils.rand_ndarray((3, 4)).asnumpy()]
        for stype in ("row_sparse", "csr"):
            a = pkg.test_utils.rand_ndarray((6, 5), stype, density=0.4)
            out += [a.stype, a.asnumpy()]
        a, dense = pkg.test_utils.rand_sparse_ndarray(
            (5, 3), "row_sparse", data_init=2.5, rsp_indices=[0, 3])
        return out + [a.asnumpy(), dense, a.indices.asnumpy()]
    port, ref = _both(case)
    for a, b in zip(port, ref):
        if isinstance(a, str):
            assert a == b
        else:
            _eq(a, b)


def test_stype_and_tostype_of_dense_arrays():
    def case(pkg):
        x = pkg.nd.array(np.array([[0, 1.5], [0, 0], [2, 0]], np.float32))
        z = pkg.nd.zeros((2, 2), stype="csr")
        x.attach_grad(stype="row_sparse")
        return [x.stype, z.stype, x.grad.stype, x.tostype("csr").stype,
                x.tostype("csr").asnumpy(), x.tostype("row_sparse")
                .indices.asnumpy(), z.asnumpy()]
    port, ref = _both(case)
    for a, b in zip(port, ref):
        if isinstance(a, str):
            assert a == b
        else:
            _eq(a, b)


def test_save_writes_the_dense_record_of_sparse_arrays():
    """``nd.save`` of a CSR and a row_sparse array: the JAX package's bytes
    exactly; a sparse record raises on load in both packages."""
    dense = np.array([[0, 1.5, 0], [0, 0, 0], [2, 0, -3]], np.float32)

    def case(pkg):
        arrays = {"csr": pkg.nd.csr_matrix(dense),
                  "rsp": pkg.nd.row_sparse_array((dense[[0, 2]], [0, 2]),
                                                 shape=(3, 3)),
                  "dense": pkg.nd.array(dense)}
        return pkg.nd.save_to_bytes(arrays)
    port, ref = _both(case)
    assert port == ref
    blob = bytearray(port)
    # the first record's stype word sits after the list header and magic
    at = 3 * 8 + 4
    assert blob[at:at + 4] == b"\0\0\0\0"
    blob[at:at + 4] = (1).to_bytes(4, "little", signed=True)
    with pytest.raises(MXNetError, match="sparse"):
        mt.nd.load_from_bytes(bytes(blob))
    with pytest.raises(mx.base.MXNetError, match="sparse"):
        mx.nd.load_from_bytes(bytes(blob))


def test_pickles_keep_the_storage_tag():
    """A pickle of either package's sparse array comes back as a dense
    array with its tag, as the JAX package's ``_nd_unpickle`` gives it."""
    dense = np.array([[0, 1.5], [2, 0]], np.float32)
    for make in (lambda pkg: pkg.nd.csr_matrix(dense),
                 lambda pkg: pkg.nd.row_sparse_array(dense)):
        mine = pickle.loads(pickle.dumps(make(mt)))
        theirs = pickle.loads(pickle.dumps(make(mx)))
        assert mine.stype == theirs.stype != "default"
        assert type(mine) is mt.nd.NDArray
        _eq(mine.asnumpy(), theirs.asnumpy())


def test_params_from_jax_keeps_tags_and_parts():
    """The JAX package's arrays themselves carried across: a CSR keeps its
    parts (explicit zeros of canonical parts included), a row_sparse array
    its tag, a tagged dense array its tag."""
    x = mt.sym.var("x", stype="csr")
    w = mt.sym.var("w", shape=(4, 2), stype="row_sparse")
    exe = mt.sym.dot(x, w).simple_bind(mt.cpu(), x=(3, 4))
    ref_x = jnd.sparse.csr_matrix(
        (np.array([0.0, 2.0, 3.0], np.float32), [0, 3, 1], [0, 2, 2, 3]),
        shape=(3, 4))
    ref_w = jnd.row_sparse_array((np.ones((1, 2), np.float32), [2]),
                                 shape=(4, 2))
    got = mt.nd.params_from_jax({"x": ref_x, "w": ref_w}, exe)
    assert got["x"].stype == "csr" and got["w"].stype == "row_sparse"
    for part in ("data", "indices", "indptr"):
        _eq(getattr(got["x"], part).asnumpy(),
            getattr(ref_x, part).asnumpy())
    _eq(got["w"].asnumpy(), ref_w.asnumpy())
    tagged = jnd.array(np.ones((4, 2), np.float32))
    tagged._stype = "row_sparse"
    arg, _ = mt.mod.params_from_jax({"w": tagged}, {}, mt.sym.dot(x, w))
    assert arg["w"].stype == "row_sparse"
    _eq(arg["w"].asnumpy(), tagged.asnumpy())


def test_var_stype_and_the_bound_csr():
    """``sym.var(stype=)`` sets ``__storage_type__`` as the JAX package
    does; the executor binds a CSR variable as an empty CSR, never a dense
    array of its shape, and a CSR fed to it flows as its parts."""
    def attrs(pkg):
        x = pkg.sym.var("data", stype="csr")
        return pkg.sym.dot(x, pkg.sym.var("w", stype="row_sparse")) \
            .attr_dict()
    port, ref = _both(attrs)
    assert port == ref
    x = mt.sym.var("data", stype="csr")
    sym = mt.sym.dot(x, mt.sym.var("w"))
    before = _densify()
    exe = sym.simple_bind(mt.cpu(), data=(4, 10 ** 7), w=(10 ** 7, 1),
                          grad_req={"data": "null", "w": "write"})
    bound = exe.arg_dict["data"]
    assert bound.stype == "csr" and bound.shape == (4, 10 ** 7)
    assert bound._dense is None and bound._parts().nnz == 0
    feed = mt.nd.csr_matrix(([2.0, 3.0], [5, 10 ** 7 - 1], [0, 1, 1, 2, 2]),
                            shape=(4, 10 ** 7))
    exe.arg_dict["w"][:] = 1.0
    out = exe.forward(is_train=True, data=feed)[0]
    exe.backward(mt.nd.array(np.ones((4, 1), np.float32)))
    _eq(out.asnumpy(), [[2.0], [0.0], [3.0], [0.0]])
    g = exe.grad_dict["w"]._data
    assert float(g[5]) == 2.0 and float(g[-1]) == 3.0 and float(g.sum()) == 5
    assert _densify() == before


def test_wide_csr_builds_no_dense():
    """At width 10^7 a ``dot`` (forward and B's gradient under
    ``autograd``) and a ``LibSVMIter`` batch build no dense matrix."""
    width = 10 ** 7
    before = _densify()
    a = mt.nd.csr_matrix(([1.5, -2.0, 4.0], [0, width - 1, 12345],
                          [0, 2, 3]), shape=(2, width))
    b = mt.nd.array(np.zeros((width, 3), np.float32))
    b[width - 1] = np.array([1.0, 2.0, 3.0], np.float32)
    b[0] = 1.0
    b.attach_grad()
    with mt.autograd.record():
        y = mt.nd.dot(a, b)
    y.backward(mt.nd.array(np.ones((2, 3), np.float32)))
    _eq(y.asnumpy(), [[-0.5, -2.5, -4.5], [0, 0, 0]])
    g = b.grad._data
    _eq(g[[0, width - 1, 12345]].numpy(), [[1.5] * 3, [-2.0] * 3, [4.0] * 3])
    t = mt.nd.dot(a, mt.nd.array(np.ones((2, 1), np.float32)),
                  transpose_a=True)
    assert t.shape == (width, 1) and float(t._data.sum()) == 3.5
    assert _densify() == before


def test_sparse_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parts = ([1.0], [0], [0, 1])
    with _no_scope():
        for make in (lambda: mt.nd.csr_matrix(parts, shape=(1, 2)),
                     lambda: mt.nd.row_sparse_array(([[1.0]], [0])),
                     lambda: mt.nd.sparse.zeros("csr", (2, 2)),
                     lambda: mt.nd.csr_matrix(parts, shape=(1, 2),
                                              ctx=mt.gpu(0))):
            with pytest.raises(MXNetError):
                make()


class _no_scope:
    """Leave the CPU scope of ``_on_cpu`` for the block."""

    def __enter__(self):
        self._held = getattr(mt.Context._default, "value", None)
        mt.Context._default.value = None

    def __exit__(self, *exc):
        mt.Context._default.value = self._held


def test_csr_copies_keep_their_parts():
    """``copyto`` a context keeps a CSR as its parts; ``copy`` gives the
    dense array, as the JAX package's does."""
    m = psp.csr_matrix(([1.0, 2.0], [1, 0], [0, 1, 2]), shape=(2, 3))
    before = _densify()
    moved = m.copyto(mt.cpu())
    assert isinstance(moved, psp.CSRNDArray)
    _eq(moved.indices.asnumpy(), [1, 0])
    assert _densify() == before
    ref = jnd.sparse.csr_matrix(([1.0, 2.0], [1, 0], [0, 1, 2]), shape=(2, 3))
    assert m.copy().stype == ref.copy().stype == "default"
    _eq(m.copy().asnumpy(), ref.copy().asnumpy())
    assert m.asscipy().nnz == ref.asscipy().nnz


@pytest.mark.parametrize("rows", [slice(0, 2), slice(1, 4), slice(3, 3),
                                  slice(2, None)])
def test_csr_parts_slice_by_rows(rows):
    """A batch's rows for one context of several (the executor group's
    slices): the parts of those rows, equal to the dense rows."""
    dense = np.array([[0, 1.5, 0], [0, 0, 0], [2, 0, -3], [0, 4, 0]],
                     np.float32)
    csr = mt.nd.csr_matrix(dense)._parts()
    part = csr[rows]
    assert part._dense is None and part.shape[1] == 3
    _eq(part.dense().numpy(), dense[rows])
    with pytest.raises(MXNetError):
        csr[::2]
