"""The product of a CSR matrix and a dense one: the CUDA kernels' wrapper,
their plain versions and the CSR parts they read.

Counterpart of ``dot``/``_sparse_dot`` with a CSR left operand
(``mxnet_tpu/ops/matrix.py:189-197``).  The JAX package backs a CSR with
a dense array and computes ``jnp.tensordot`` on it, outside any Pallas
kernel; here a CSR stays as its three parts (:class:`CSR`) and the
product reads them, so a batch at avazu-app's 1,000,001 features (8192
rows: 32.8 GB dense) costs its nonzeros.  ``csrc/csr_dot.cu`` (CUDA C++
for ``sm_90a``, built by ``_build.load_library`` at its first launch)
holds the kernels:

- ``csr_dot_kernel``: out (M, N) = A (M x K, CSR) . B (K, N) at N up to
  4: 16 lanes a row and a lane an entry, so a row's gathers are all in
  flight, the products then added in stored order by shuffles (a longer
  row in chunks of 16 with the carry); ``csr_dot_wide_kernel`` at wider
  N, a lane an output column, the entries' gathers 8 at a time;
- the transposition: ``csr_transpose_kernel`` then a stable LSD radix
  sort by column
  (``radix_hist_kernel``, ``radix_prefix_kernel`` and
  ``radix_scatter_kernel`` a pass, digits of up to 10 bits, so two passes
  at 1,000,001 columns): A's entries in column order, rows in order
  within a column;
- ``csr_t_dot_kernel`` and ``csr_t_dot_combine_kernel``: out (K, N) =
  A^T . G (M, N).  The columns are Zipf-skewed on the path (a few hold an
  entry in nearly every row), so a warp takes a tile of 32 sorted
  entries and sums each run of equal columns in it in row order; a run
  that crosses tiles leaves a partial sum a tile, which the second kernel
  adds in tile order.  The output is zeroed, then every column that holds
  entries is written once.  One call (``mx_csr_t_dot``) launches the
  transposition and these; ``mx_csr_transpose`` launches the
  transposition alone, for its check.

A CSR may sit in buffers of a fixed ``capacity`` above its nnz (a
captured step's static input: :meth:`CSR.capacity`, values past nnz
zero, ``indptr`` exact).  The kernels read nnz as ``indptr[M]`` on the
card and size every grid, workspace and scratch by the capacity, so no
launch reads nnz on the host and a CUDA graph replays one launch for any
batch that fits; the plain versions send the slots past nnz to a row past
the output's last, which is dropped, so they give the same bits padded
or not.

No atomic touches a float, so two calls give the same bits.  Each
product rounds as the plain version does (a product, then a sum, with no
fused multiply-add): ``csr_dot`` adds in the plain version's order, so
the card's float64 equals the CPU's to the last bit; ``csr_t_dot`` adds
in that order too where a column's entries lie in one tile, and the
tiles' partial sums in tile order where they cross.

:func:`dot` is the op's route for a :class:`CSR` left operand: float32
and float64 through the kernels, behind :class:`_CSRDot`, whose backward
gives B's gradient (A^T . dOut, or A . dOut with ``transpose_a``).  A
CPU tensor goes through the plain versions (a gather, a multiply and an
``index_add_`` over the parts in stored order; no dense matrix), and a
CPU CSR of another dtype through its dense view, counted in
``sparse_densify``; a CUDA tensor launches the kernels or raises, and a
CUDA CSR of another dtype, or one whose operand's dtype differs, raises
(its dense view is 32.8 GB at avazu-app's width).  Launches count in
``profiler`` under ``csr_dot_launches``, ``csr_t_dot_launches`` and
``csr_transpose_launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from .. import profiler
from . import _build

__all__ = ["CSR", "dot", "csr_dot", "csr_t_dot", "csr_dot_reference",
           "csr_t_dot_reference", "t_dot_tiles_reference",
           "transpose_parts", "transpose_parts_reference", "sort_digits",
           "entry_rows",
           "KERNEL_SOURCE", "COUNTERS", "DENSIFY_COUNTER", "KERNEL_DTYPES"]

KERNEL_SOURCE = "mxnet_tpu_torch/ops/csrc/csr_dot.cu"
COUNTERS = {"csr_dot": "csr_dot_launches", "csr_t_dot": "csr_t_dot_launches",
            "csr_transpose": "csr_transpose_launches"}
DENSIFY_COUNTER = "sparse_densify"
KERNEL_DTYPES = (torch.float32, torch.float64)
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_MAX_DIGIT_BITS = 10       # radix_*_kernel: digits of up to 10 bits
_SORT_ITEMS = 256 * 8      # radix_*_kernel: 256 threads x 8 chunks a block
_TILE = 32                 # csr_t_dot_kernel: sorted entries a warp
_INT32_MAX = 2 ** 31 - 1


def entry_rows(indptr, capacity):
    """The row of each of the ``capacity`` slots (int64), from the row
    pointers on their device, with no read of nnz on the host: a slot past
    nnz (``indptr[-1]``) gets row M, one past the last."""
    slots = torch.arange(capacity, device=indptr.device)
    return torch.searchsorted(indptr, slots, right=True) - 1


class CSR:
    """A compressed-sparse-row matrix of ``shape`` (M, K) as its parts on
    one device: ``values`` (capacity,), ``indices`` (capacity,) int64
    column ids, ``indptr`` (M + 1,) int64 row pointers.  nnz is
    ``indptr[-1]``; the slots past it (a captured step's buffers of a
    fixed capacity) hold zeros and column 0.  The op layer passes it where
    an op takes a CSR operand (the registry's ``csr_inputs``); any other
    op reads :meth:`dense`, built once and counted."""
    __slots__ = ("values", "indices", "indptr", "shape", "_dense")

    def __init__(self, values, indices, indptr, shape):
        self.values = values.contiguous()
        self.indices = indices.contiguous()
        self.indptr = indptr.contiguous()
        self.shape = tuple(int(s) for s in shape)
        self._dense = None

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def capacity(self):
        """The slots of ``values`` and ``indices``: nnz or more."""
        return self.values.numel()

    @property
    def nnz(self):
        """The entries, ``indptr[-1]``, read on the host (a sync on the
        card; no kernel takes it)."""
        return int(self.indptr[-1]) if self.indptr.numel() else 0

    def trimmed(self):
        """The CSR without the slots past nnz (views; ``self`` where there
        are none)."""
        nnz = self.nnz
        if nnz == self.capacity:
            return self
        return CSR(self.values[:nnz], self.indices[:nnz], self.indptr,
                   self.shape)

    def shell(self):
        """The same parts with no cached dense view: a captured step reads
        its static CSR through a new shell each run, so its dense view is
        built inside the program on every replay."""
        return CSR(self.values, self.indices, self.indptr, self.shape)

    def detach(self):
        return self

    def to(self, device, dtype=None, non_blocking=False):
        """A copy on ``device`` (values in ``dtype``): three copies."""
        dtype = dtype or self.dtype
        return CSR(self.values.to(device, dtype, non_blocking=non_blocking,
                                  copy=True),
                   self.indices.to(device, non_blocking=non_blocking,
                                   copy=True),
                   self.indptr.to(device, non_blocking=non_blocking,
                                  copy=True), self.shape)

    def dense(self):
        """The (M, K) dense matrix, built at the first call and counted
        in ``sparse_densify``; no read of nnz on the host (the slots past
        it go to a row past the last, which is dropped)."""
        if self._dense is None:
            profiler.bump(DENSIFY_COUNTER)
            m, k = self.shape
            out = torch.zeros((m + 1, k), dtype=self.dtype,
                              device=self.device)
            if self.capacity:
                out.index_put_((entry_rows(self.indptr, self.capacity),
                                self.indices), self.values, accumulate=True)
            self._dense = out[:m]
        return self._dense

    def row_slice(self, start, stop):
        """Rows [start, stop) as a CSR of their own (copies)."""
        lo, hi = (int(v) for v in self.indptr[[start, stop]].tolist())
        return CSR(self.values[lo:hi].clone(), self.indices[lo:hi].clone(),
                   self.indptr[start:stop + 1] - lo,
                   (stop - start, self.shape[1]))

    def __getitem__(self, key):
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise MXNetError("a CSR's parts slice by rows only")
        start, stop, _ = key.indices(self.shape[0])
        return self.row_slice(start, max(start, stop))

    @staticmethod
    def from_dense(t):
        """The canonical parts of a 2-D tensor (row-major, sorted
        columns, no zero kept), as scipy's ``csr_matrix(dense)`` gives
        them."""
        if t.dim() != 2:
            raise MXNetError("a CSR is 2-D, got shape %s" % (tuple(t.shape),))
        t = t.detach()
        nz = t != 0
        rows, cols = nz.nonzero(as_tuple=True)
        indptr = torch.zeros(t.shape[0] + 1, dtype=torch.int64,
                             device=t.device)
        torch.cumsum(nz.sum(1), 0, out=indptr[1:])
        return CSR(t[rows, cols], cols, indptr, t.shape)


# -- plain versions ----------------------------------------------------------
def csr_dot_reference(csr, b):
    """A (M x K, CSR) . b (K, N) -> (M, N): a gather, a multiply and an
    ``index_add_`` in stored order (the slots past nnz into a row past the
    last, dropped)."""
    m = csr.shape[0]
    out = torch.zeros((m + 1, b.shape[1]), dtype=b.dtype, device=b.device)
    if csr.capacity:
        out.index_add_(0, entry_rows(csr.indptr, csr.capacity),
                       csr.values[:, None] * b.index_select(0, csr.indices))
    return out[:m]


def csr_t_dot_reference(csr, g):
    """A^T . g (M, N) -> (K, N), the same way (the slots past nnz into a
    row past the last, dropped; nnz compared on the device)."""
    (m, k), cap = csr.shape, csr.capacity
    out = torch.zeros((k + 1, g.shape[1]), dtype=g.dtype, device=g.device)
    if m and cap:
        slots = torch.arange(cap, device=csr.indptr.device)
        cols = torch.where(slots < csr.indptr[-1], csr.indices, k)
        rows = entry_rows(csr.indptr, cap).clamp_(max=m - 1)
        out.index_add_(0, cols,
                       csr.values[:, None] * g.index_select(0, rows))
    return out[:k]


def transpose_parts_reference(csr):
    """(keys, perm, rows), int32, as :func:`transpose_parts` builds them:
    a stable argsort of the column ids, the ids in that order, and each
    entry's row (nnz of each)."""
    csr = csr.trimmed()
    rows = entry_rows(csr.indptr, csr.capacity)
    perm = torch.argsort(csr.indices, stable=True)
    return csr.indices[perm].int(), perm.int(), rows.int()


def t_dot_tiles_reference(csr, g):
    """A^T . g in ``csr_t_dot_kernel``'s order, in plain PyTorch: each
    run of equal columns in a tile of 32 sorted entries summed in row
    order from 0, then a run's partial sums over the tiles it crosses in
    tile order; products and sums rounded apart."""
    csr = csr.trimmed()
    keys, perm, rows = transpose_parts_reference(csr)
    out = torch.zeros((csr.shape[1], g.shape[1]), dtype=g.dtype,
                      device=g.device)
    nnz = csr.capacity
    if not nnz:
        return out
    keys, perm = keys.long(), perm.long()
    prods = csr.values[perm][:, None] * g[rows.long()[perm]]
    j = torch.arange(nnz, device=keys.device)
    new_run = torch.ones_like(keys, dtype=torch.bool)
    new_run[1:] = (keys[1:] != keys[:-1]) | (j[1:] % _TILE == 0)
    starts = new_run.nonzero().reshape(-1).tolist() + [nnz]
    cols = keys.tolist()
    for a, b in zip(starts[:-1], starts[1:]):
        part = torch.zeros(g.shape[1], dtype=g.dtype, device=g.device)
        for x in prods[a:b]:
            part = part + x
        c = cols[a]
        out[c] = part if a == 0 or cols[a - 1] != c else out[c] + part
    return out


# -- the kernels -------------------------------------------------------------
def _lib():
    lib = _build.load_library("csr_dot")
    if lib.mx_csr_dot.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mx_csr_dot.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.mx_csr_t_dot.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                     i, p]
        lib.mx_csr_transpose.argtypes = [p, p, i, i, p, i, i, p]
        for fn in (lib.mx_csr_dot, lib.mx_csr_t_dot, lib.mx_csr_transpose):
            fn.restype = ctypes.c_int
    return lib


def _check(err, what, csr):
    if err != 0:
        raise MXNetError("%s: kernel launch failed with cudaError_t %d at "
                         "%s, capacity %d, %s" % (what, err, csr.shape,
                                                  csr.capacity, csr.dtype))


def _dense_operand(csr, b, rows, what):
    """``b`` checked as the (rows, N) operand of a kernel of ``csr``."""
    if b.device.type != "cuda" or csr.device != b.device:
        raise MXNetError("%s: the CSR lies on %s and its operand on %s"
                         % (what, csr.device, b.device))
    if b.dim() != 2 or b.shape[0] != rows or b.dtype != csr.dtype \
            or csr.dtype not in KERNEL_DTYPES:
        raise MXNetError("%s: a %s (%d, N) operand expected, got %s %s"
                         % (what, csr.dtype, rows, b.dtype,
                            tuple(b.shape)))
    if max(csr.shape) > _INT32_MAX or csr.capacity > _INT32_MAX \
            or b.shape[1] > _INT32_MAX:
        raise MXNetError("%s: %s with room for %d entries exceeds the "
                         "kernels' 32-bit sizes" % (what, csr.shape,
                                                    csr.capacity))
    return b.contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def sort_digits(k):
    """(passes, bits a digit) of the radix sort of column ids below
    ``k``: as few passes of at most 10 bits as cover the ids."""
    bits = max(1, (int(k) - 1).bit_length())
    passes = -(-bits // _MAX_DIGIT_BITS)
    return passes, -(-bits // passes)


def _transpose_ints(capacity, digit_bits):
    """The int32 words of the transposition's workspace at ``capacity``:
    rows, two (keys, perm) pairs, the radix passes' histograms and the
    digits' totals."""
    blocks = -(-capacity // _SORT_ITEMS)
    return 5 * capacity + ((blocks + 1) << digit_bits)


def transpose_parts(csr):
    """(keys, perm, rows), int32, of a CSR: its entries by column, rows in
    order within a column: their column ids, their places in the CSR, and
    the row of each CSR entry.  On the card this is the transposition that
    :func:`csr_t_dot` runs first, launched alone (for its check), each
    part (capacity,) with the entries in its first nnz slots (the rest
    unspecified; no read of nnz on the host); on the CPU the plain
    version, each (nnz,)."""
    if csr.device.type == "cpu":
        return transpose_parts_reference(csr)
    (m, k), cap = csr.shape, csr.capacity
    passes, digit_bits = sort_digits(k)
    ws = torch.empty(_transpose_ints(cap, digit_bits), dtype=torch.int32,
                     device=csr.device)
    if m and cap:
        with torch.cuda.device(csr.device):
            _check(_lib().mx_csr_transpose(
                csr.indptr.data_ptr(), csr.indices.data_ptr(), m, cap,
                ws.data_ptr(), passes, digit_bits, _stream(csr.values)),
                "csr_transpose", csr)
        profiler.bump(COUNTERS["csr_transpose"], 1 + 3 * passes)
    pair = 1 + 2 * (passes % 2)
    return (ws[pair * cap:(pair + 1) * cap],
            ws[(pair + 1) * cap:(pair + 2) * cap], ws[:cap])


def csr_dot(csr, b):
    """A (M x K, CSR) . b (K, N) -> (M, N).  CPU: the plain version;
    CUDA: ``csr_dot_kernel`` (N up to 4) or ``csr_dot_wide_kernel``."""
    if b.device.type == "cpu" and csr.device.type == "cpu":
        return csr_dot_reference(csr, b)
    b = _dense_operand(csr, b, csr.shape[1], "csr_dot")
    m, n = csr.shape[0], b.shape[1]
    out = torch.empty((m, n), dtype=b.dtype, device=b.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(b.device):
        _check(_lib().mx_csr_dot(
            csr.indptr.data_ptr(), csr.indices.data_ptr(),
            csr.values.data_ptr(), b.data_ptr(), out.data_ptr(), m, n,
            _DTYPE_CODE[b.dtype], _stream(b)), "csr_dot", csr)
    profiler.bump(COUNTERS["csr_dot"])
    return out


def csr_t_dot(csr, g):
    """A^T . g (M, N) -> (K, N).  CPU: the plain version; CUDA: one call
    that zeroes out, runs the transposition and then ``csr_t_dot_kernel``
    and ``csr_t_dot_combine_kernel``, every size from the capacity."""
    if g.device.type == "cpu" and csr.device.type == "cpu":
        return csr_t_dot_reference(csr, g)
    g = _dense_operand(csr, g, csr.shape[0], "csr_t_dot")
    (m, k), n, cap = csr.shape, g.shape[1], csr.capacity
    out = torch.empty((k, n), dtype=g.dtype, device=g.device)
    if k == 0 or n == 0:
        return out
    passes, digit_bits = sort_digits(k)
    ws = torch.empty(_transpose_ints(cap, digit_bits), dtype=torch.int32,
                     device=g.device)
    scratch = torch.empty(2 * -(-cap // _TILE) * n, dtype=g.dtype,
                          device=g.device)
    with torch.cuda.device(g.device):
        _check(_lib().mx_csr_t_dot(
            csr.indptr.data_ptr(), csr.indices.data_ptr(),
            csr.values.data_ptr(), g.data_ptr(), out.data_ptr(),
            ws.data_ptr(), scratch.data_ptr(), m, k, n, cap, passes,
            digit_bits, _DTYPE_CODE[g.dtype], _stream(g)), "csr_t_dot", csr)
    if m and cap:
        profiler.bump(COUNTERS["csr_transpose"], 1 + 3 * passes)
    profiler.bump(COUNTERS["csr_t_dot"])
    return out


class _CSRDot(torch.autograd.Function):
    """``dot(A, b)`` (or ``dot(A, b, transpose_a=True)``) for a CSR A
    that takes no gradient; the backward gives b's.  That gradient is the
    product with A the other way round, itself a ``_CSRDot``, so under
    ``create_graph`` it is differentiable in ``g`` through the kernels
    again (a kernel's output alone would drop the term)."""

    @staticmethod
    def forward(ctx, b, csr, transpose_a):
        ctx.csr, ctx.transpose_a = csr, transpose_a
        return csr_t_dot(csr, b) if transpose_a else csr_dot(csr, b)

    @staticmethod
    def backward(ctx, g):
        return (_CSRDot.apply(g.contiguous(), ctx.csr, not ctx.transpose_a),
                None, None)


def dot(csr, b, transpose_a=False, transpose_b=False):
    """MXNet's ``dot`` with a CSR left operand: A (M, K) contracted with
    b's first axis (after ``transpose_b``), A^T with ``transpose_a``."""
    if transpose_b and b.dim() > 1:
        b = torch.swapaxes(b, -1, -2)
    inner = csr.shape[0] if transpose_a else csr.shape[1]
    if b.dim() == 0 or b.shape[0] != inner:
        raise MXNetError("dot: a CSR of shape %s%s cannot multiply shape %s"
                         % (csr.shape, " transposed" if transpose_a else "",
                            tuple(b.shape)))
    if b.device != csr.device:
        raise MXNetError("dot: the CSR lies on %s and its operand on %s"
                         % (csr.device, b.device))
    if b.dtype != csr.dtype:
        raise MXNetError("dot: a %s CSR cannot multiply a %s operand"
                         % (csr.dtype, b.dtype))
    if csr.dtype not in KERNEL_DTYPES:
        if csr.device.type != "cpu":
            raise MXNetError(
                "dot: the csr_dot kernels take %s, not a %s CSR on %s"
                % (" or ".join(str(d) for d in KERNEL_DTYPES), csr.dtype,
                   csr.device))
        a = csr.dense()
        a = a.t() if transpose_a else a
        return torch.tensordot(a, b, dims=([1], [0]))
    tail = tuple(b.shape[1:])
    out = _CSRDot.apply(b.reshape(inner, -1), csr, bool(transpose_a))
    return out.reshape((csr.shape[1] if transpose_a else csr.shape[0],)
                       + tail)
