"""Sparse NDArrays: ``row_sparse`` and ``csr``.

Counterpart of ``mxnet_tpu/ndarray/sparse.py``, with its API and its
values (``indices``, ``indptr``, ``data``, ``tostype``, ``retain``,
``asscipy``; ``row_sparse_array``, ``csr_matrix``, ``cast_storage``,
``zeros``).  The JAX package backs both types with a dense array, because
XLA wants static shapes (``:6-14``).  Here:

- a :class:`RowSparseNDArray` is dense-backed as there: on every path of
  the JAX package it is a weight or its gradient, dense-sized anyway.
  Its active rows are seeded by the constructor (and by
  ``kvstore.row_sparse_pull``), dropped by any write (the tensor's
  version counter moves) and recomputed on its device as the rows that
  are not all zero (``:64-73``);
- a :class:`CSRNDArray` holds its parts (``ops.sparse_dot.CSR``: values,
  int64 column ids, int64 row pointers) on its context, and no dense
  matrix.  ``dot`` with a CSR left operand reads the parts (the
  ``csr_dot`` kernels on the card); any other op, ``asnumpy`` and a write
  read the dense view, built then and counted in ``profiler`` under
  ``sparse_densify``.  A write to the dense view makes the parts stale,
  and they are recomputed in canonical form (explicit zeros dropped,
  columns sorted), as scipy's ``csr_matrix(dense)`` gives them.  Given
  parts are kept, as copies, only when canonical (no repeated column in
  a row, columns sorted); otherwise repeated columns sum (``np.add.at``,
  in their order) and zeros are dropped (``:96-213``).

A batch copied into a bound CSR (``_set_data`` with a CSR: an
executor's feed) goes into buffers of a fixed capacity, in place, so a
captured step reads it at the same addresses every step: values past the
batch's nnz zero, column ids past it 0, the row pointers exact.  The
first batch sets the capacity to its nnz rounded up to a power of two; a
batch that does not fit doubles it (until it fits) into new buffers, and
a captured step that held the old ones captures again.  So the buffers
hold less than twice the largest batch's parts, and batches whose nnz
goes up and down within the capacity replay one program.

``copyto`` a context and ``as_in_context`` keep a CSR as its parts;
``copy``, ``astype``, slicing and the other ops give dense arrays, as
the JAX package's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..context import Context, as_context
from .. import capture, profiler
from ..ops.registry import get_op
from ..ops.sparse_dot import CSR, DENSIFY_COUNTER, entry_rows
from .ndarray import NDArray, invoke, zeros as _dense_zeros

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "cast_storage", "zeros",
           "raw", "tensors", "capacities", "from_reference"]


def _np_dtype(dtype):
    """numpy dtype of a user dtype, float32 for None (``dtype_np``)."""
    return np.dtype(np.float32) if dtype is None else np.dtype(dtype)


def raw(x):
    """What an executor or a copy takes from ``x``: the parts of a CSR,
    the tensor of any other NDArray."""
    return x._parts() if isinstance(x, CSRNDArray) else x._data


def tensors(x):
    """The tensors a captured step reads of ``x``: a CSR's three parts,
    the tensor of any other NDArray."""
    if isinstance(x, CSRNDArray):
        c = x._parts()
        return [c.values, c.indices, c.indptr]
    return [x._data]


def capacities(arrays):
    """The capacity of each CSR among ``arrays`` (a captured step's key)."""
    return tuple(a._parts().capacity for a in arrays
                 if isinstance(a, CSRNDArray))


def _capacity_for(need, cap):
    """The capacity for a batch of ``need`` entries in buffers of ``cap``:
    ``cap`` where it fits; else ``cap`` doubled until it does, or, for the
    first batch (``cap`` 0), ``need`` rounded up to a power of two."""
    if cap == 0:
        return 1 << max(need - 1, 0).bit_length()
    while cap < need:
        cap *= 2
    return cap


class BaseSparseNDArray(NDArray):
    __slots__ = ()

    def __repr__(self):
        return "\n<%s %s @%s>" % (type(self).__name__,
                                  "x".join(str(s) for s in self.shape),
                                  self.context)

    def asscipy(self):
        raise MXNetError("asscipy only supported for csr")


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse array over a dense tensor: the active rows and their
    values are kept where a constructor or a pull seeded them, until the
    tensor is written."""
    __slots__ = ("_idx", "_vals", "_seen")

    def __init__(self, data, ctx):
        super().__init__(data, ctx, "row_sparse")
        self._idx = self._vals = None
        self._seen = -1

    def _seed_sparse(self, indices, values):
        dev = self._data.device
        self._idx = indices.to(dev, torch.int64)
        self._vals = None if values is None else values.to(dev)
        self._seen = self._data._version

    def _active_rows(self):
        if self._idx is None or self._seen != self._data._version:
            flat = self._data.detach().reshape(self.shape[0], -1)
            self._seed_sparse(flat.ne(0).any(1).nonzero().reshape(-1), None)
        return self._idx

    @property
    def indices(self):
        return NDArray(self._active_rows().clone(), self._ctx)

    @property
    def data(self):
        rows = self._active_rows()
        if self._vals is None:
            self._vals = self._data.detach().index_select(0, rows)
        return NDArray(self._vals.clone(), self._ctx)

    def retain(self, indices):
        return invoke(get_op("sparse_retain"), [self, indices], {})[0]


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix held as its parts on its context; the
    dense view is built only where something reads it."""
    __slots__ = ("_csr", "_dense", "_dense_ver", "_shape")

    def __init__(self, csr, ctx):
        self._csr, self._dense, self._dense_ver = csr, None, -1
        self._shape = tuple(csr.shape)
        super().__init__(None, ctx, "csr")

    # the dense view stands where an NDArray keeps its tensor
    @property
    def _data(self):
        if self._dense is None:
            self._dense = self._parts().dense()
            self._dense_ver = self._dense._version
        return self._dense

    @_data.setter
    def _data(self, t):
        keep = t is not None and self._dense is not None \
            and t.data_ptr() == self._dense.data_ptr() \
            and t._version == self._dense_ver
        if t is not None and not keep:
            self._csr = None   # parts recomputed from t at the next read
        self._dense = t

    def _parts(self):
        """The parts (``CSR``), recomputed from the dense view where it
        was written since."""
        if self._dense is not None and self._dense._version \
                != self._dense_ver:
            self._csr = None
        if self._csr is None:
            self._csr = CSR.from_dense(self._dense)
            self._dense_ver = self._dense._version
        return self._csr

    def _operand(self):
        return self._data if self._marked else self._parts()

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        t = self._csr.values if self._csr is not None else self._dense
        return np_dtype(t.dtype)

    @property
    def size(self):
        return int(np.prod(self._shape))

    @property
    def ndim(self):
        return 2

    def _set_data(self, src):
        """Replace the contents: by a copy of a ``CSR``'s parts (three
        copies to this context), or of a dense tensor."""
        dev = self._ctx.torch_device
        dtype = torch_dtype(self.dtype)
        if isinstance(src, CSR):
            if tuple(src.shape) != self._shape:
                raise MXNetError("cannot copy a CSR of shape %s into one of "
                                 "shape %s" % (src.shape, self._shape))
            self._fill(src, dev, dtype)
            return self
        dense = torch.empty(self._shape, dtype=dtype, device=dev)
        with torch.no_grad():
            dense.copy_(src)
        self._dense, self._dense_ver, self._csr = dense, -1, None
        return self

    def _fill(self, src, dev, dtype):
        """Copy ``src``'s entries into this array's capacity buffers (see
        the module's notes), in place where they fit; each host part goes
        through pinned memory, so the copy does not wait for the card."""
        src = src.trimmed()
        need = src.capacity
        c = self._csr
        fits = c is not None and c.dtype == dtype and c.device == dev
        cap = _capacity_for(need, c.capacity if fits else 0)
        if not fits or cap != c.capacity:
            c = CSR(torch.zeros(cap, dtype=dtype, device=dev),
                    torch.zeros(cap, dtype=torch.int64, device=dev),
                    torch.empty(self._shape[0] + 1, dtype=torch.int64,
                                device=dev), self._shape)
        with torch.no_grad():
            for dst, part in ((c.values, src.values),
                              (c.indices, src.indices)):
                capture.fill(dst[:need], part)
                dst[need:].zero_()
            capture.fill(c.indptr, src.indptr)
        # a new shell: a dense view of the old contents is not kept
        self._csr = c.shell()
        self._dense, self._dense_ver = None, -1

    def wait_to_read(self):
        dev = self._ctx.torch_device
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self):
        c = self._parts()
        if self._dense is not None or c._dense is not None:
            return super().asnumpy()
        profiler.bump(DENSIFY_COUNTER)
        c = c.trimmed()
        values = c.values.detach().cpu()
        if values.dtype == torch.bfloat16:
            values = values.float()
        out = np.zeros(self._shape, dtype=values.numpy().dtype)
        rows = entry_rows(c.indptr, c.capacity).cpu().numpy()
        np.add.at(out, (rows, c.indices.cpu().numpy()), values.numpy())
        return out

    def copyto(self, other):
        if isinstance(other, Context):
            return CSRNDArray(self._parts().trimmed().to(other.torch_device),
                              other)
        if isinstance(other, NDArray):
            if other is not self:
                other._set_data(raw(self) if isinstance(other, CSRNDArray)
                                else self._data)
            return other
        raise TypeError("copyto does not support type " + str(type(other)))

    @property
    def indices(self):
        return NDArray(self._parts().trimmed().indices.clone(), self._ctx)

    @property
    def indptr(self):
        return NDArray(self._parts().indptr.clone(), self._ctx)

    @property
    def data(self):
        return NDArray(self._parts().trimmed().values.clone(), self._ctx)

    def asscipy(self):
        import scipy.sparse as sp
        c = self._parts().trimmed()
        m = sp.csr_matrix((c.values.cpu().numpy(), c.indices.cpu().numpy(),
                           c.indptr.cpu().numpy()), shape=self._shape)
        m.eliminate_zeros()
        return m


def _csr_on(values, indices, indptr, shape, ctx):
    """A CSRNDArray of host numpy parts, copied to ``ctx``."""
    dev = ctx.torch_device
    return CSRNDArray(CSR(torch.from_numpy(np.array(values)).to(dev),
                          torch.from_numpy(np.array(indices, np.int64))
                          .to(dev),
                          torch.from_numpy(np.array(indptr, np.int64))
                          .to(dev), shape), ctx)


def _canonical(values, indices, indptr, shape):
    """Host parts in canonical form: repeated columns of a row summed in
    their order, columns sorted, zeros dropped."""
    m, k = shape
    rows = np.repeat(np.arange(m), np.diff(indptr))
    uniq, inv = np.unique(rows * max(k, 1) + indices, return_inverse=True)
    sums = np.zeros(uniq.shape, dtype=values.dtype)
    np.add.at(sums, inv.reshape(-1), values)
    keep = sums != 0
    uniq, sums = uniq[keep], sums[keep]
    counts = np.bincount(uniq // max(k, 1), minlength=m)
    return sums, uniq % max(k, 1), np.concatenate(
        [[0], np.cumsum(counts)]).astype(np.int64)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from (data, indices, indptr), an NDArray, a scipy
    sparse matrix or a dense array-like."""
    ctx = as_context(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        data = np.asarray(data, dtype=_np_dtype(dtype))
        indices = np.asarray(indices, dtype=np.int64).reshape(-1)
        indptr = np.asarray(indptr, dtype=np.int64).reshape(-1)
        if shape is None:
            shape = (len(indptr) - 1,
                     int(indices.max()) + 1 if indices.size else 0)
        shape = tuple(int(s) for s in shape)
        if len(shape) != 2 or len(indptr) != shape[0] + 1 \
                or indptr[0] != 0 or np.any(np.diff(indptr) < 0) \
                or indptr[-1] != indices.size or data.size != indices.size:
            raise MXNetError("csr_matrix: parts of %d values, %d indices "
                             "and %d row pointers do not make shape %s"
                             % (data.size, indices.size, indptr.size, shape))
        if indices.size and (indices.min() < 0 or indices.max() >= shape[1]):
            raise MXNetError("csr_matrix: a column id lies outside [0, %d)"
                             % shape[1])
        rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
        flat = rows * max(shape[1], 1) + indices
        if flat.size and not bool(np.all(np.diff(flat) > 0)):
            data, indices, indptr = _canonical(data, indices, indptr, shape)
        return _csr_on(data, indices, indptr, shape, ctx)
    if isinstance(arg1, NDArray):
        return cast_storage(arg1, "csr")
    if hasattr(arg1, "toarray"):   # scipy sparse
        m = arg1.tocsr(copy=True)
        m.sum_duplicates()
        m.data = m.data.astype(_np_dtype(dtype))
        m.eliminate_zeros()
        m.sort_indices()
        return _csr_on(m.data, m.indices, m.indptr, m.shape, ctx)
    dense = torch.from_numpy(np.asarray(arg1).astype(_np_dtype(dtype)))
    return CSRNDArray(CSR.from_dense(dense).to(ctx.torch_device), ctx)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from (data, indices), an NDArray or a dense
    array-like."""
    ctx = as_context(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        data = np.asarray(data, dtype=_np_dtype(dtype))
        indices = np.asarray(indices, dtype=np.int64).reshape(-1)
        if shape is None:
            nrows = int(indices.max()) + 1 if indices.size else 0
            shape = (nrows,) + tuple(data.shape[1:])
        dense = np.zeros(shape, dtype=data.dtype)
        if indices.size:
            dense[indices] = data
        dev = ctx.torch_device
        out = RowSparseNDArray(torch.from_numpy(dense).to(dev), ctx)
        out._seed_sparse(torch.from_numpy(indices),
                         torch.from_numpy(data.copy()))
        return out
    if isinstance(arg1, NDArray):
        return cast_storage(arg1, "row_sparse")
    dense = np.array(arg1, dtype=_np_dtype(dtype))
    return RowSparseNDArray(torch.from_numpy(dense).to(ctx.torch_device),
                            ctx)


def cast_storage(arr, stype):
    """``arr`` in storage ``stype`` (the array itself where it already is):
    a copy, never a view of ``arr``."""
    if stype == arr.stype:
        return arr
    if stype == "csr":
        return CSRNDArray(CSR.from_dense(arr._data), arr.context)
    if stype == "row_sparse":
        return RowSparseNDArray(arr._data.detach().clone(), arr.context)
    if stype == "default":
        return NDArray(arr._data.detach().clone(), arr.context)
    raise MXNetError("unknown storage type %r" % (stype,))


def zeros(stype, shape, ctx=None, dtype=None):
    """All-zero array of storage ``stype``; a CSR holds no entry and
    allocates no dense matrix."""
    if stype == "default":
        return _dense_zeros(shape, ctx=ctx, dtype=dtype)
    ctx = as_context(ctx)
    dev, dt = ctx.torch_device, torch_dtype(dtype)
    if stype == "row_sparse":
        return RowSparseNDArray(torch.zeros(shape, dtype=dt, device=dev),
                                ctx)
    if stype == "csr":
        shape = tuple(int(s) for s in shape)
        if len(shape) != 2:
            raise MXNetError("a CSR is 2-D, got shape %s" % (shape,))
        return CSRNDArray(CSR(torch.empty(0, dtype=dt, device=dev),
                              torch.empty(0, dtype=torch.int64, device=dev),
                              torch.zeros(shape[0] + 1, dtype=torch.int64,
                                          device=dev), shape), ctx)
    raise MXNetError("unknown storage type %r" % (stype,))


def from_reference(value, ctx, dtype=None):
    """An array of the JAX package (anything with ``asnumpy``, and
    ``stype``, ``indices``, ``indptr`` and ``data`` where it has them) as
    this package's on ``ctx``, its storage tag kept: a CSR by its parts,
    a row_sparse array dense-backed, any other tagged array dense with its
    tag."""
    stype = getattr(value, "stype", "default")
    if stype == "csr" and hasattr(value, "indptr"):
        return csr_matrix((value.data.asnumpy(), value.indices.asnumpy(),
                           value.indptr.asnumpy()), shape=value.shape,
                          ctx=ctx, dtype=dtype or value.dtype)
    dense = np.asarray(value.asnumpy(), dtype=dtype)
    if stype == "row_sparse" and hasattr(value, "indices"):
        return row_sparse_array(dense, ctx=ctx, dtype=dense.dtype)
    return NDArray(torch.from_numpy(dense.copy()).to(
        as_context(ctx).torch_device), as_context(ctx), stype)
