"""Data iterators.

Counterpart of ``mxnet_tpu/io.py`` (``DataDesc`` :67, ``DataBatch``
:106, ``DataIter`` :119, ``ResizeIter`` :214, ``_Slot`` :256,
``PrefetchingIter`` :301, ``_init_data`` :372, ``NDArrayIter`` :400,
``_WrappedArrayIter`` :527, ``CSVIter`` :550, ``_read_idx_file`` :569,
``MNISTIter`` :582): ``last_batch_handle`` ``pad`` (wrap the tail batch
around and report the pad), ``discard`` (drop it) or ``roll_over``
(carry it into the next epoch); ``shuffle`` draws from the framework's
host generator (``random.host_rng``), so a seeded shuffle gives the JAX
package's order.  As in MXNet the batches are staged in host memory
(NDArrays on ``cpu()``): the executor copies each into its bound arrays
on the card, a Gluon loop with ``split_and_load`` or ``as_in_context``.
``PrefetchingIter`` fills the next batch of each source on a thread of
its own.  ``LibSVMIter`` (``:603-657``) parses its file into CSR parts
on the host, never into a dense matrix, and emits CSR batches
(``ndarray.sparse.CSRNDArray`` on ``cpu()``), which the executor copies
to its bound CSR on the card as three copies.  The JAX package's batch-wait telemetry
(``_timed_batch``) waits for the telemetry port (A.11).
"""
from __future__ import annotations

import os
import struct
import threading

import numpy as np
import torch

from .base import MXNetError
from .context import cpu
from . import ndarray as nd
from . import random as _random
from .ndarray import NDArray
from .ndarray.sparse import CSRNDArray
from .ops.sparse_dot import CSR

__all__ = ["DataDesc", "DataBatch", "DataIter", "ResizeIter",
           "PrefetchingIter", "NDArrayIter", "CSVIter", "MNISTIter",
           "LibSVMIter"]


class DataDesc:
    """name/shape/dtype/layout of one input; behaves as (name, shape)."""

    def __init__(self, name, shape, dtype=np.float32, layout="NCHW"):
        self.name, self.shape = name, tuple(shape)
        self.dtype, self.layout = dtype, layout

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape,
                                          self.dtype, self.layout)

    def __iter__(self):
        return iter((self.name, self.shape))

    def __getitem__(self, i):
        return (self.name, self.shape)[i]

    def __len__(self):
        return 2

    def __eq__(self, other):
        if isinstance(other, (tuple, list)):
            return (self.name, self.shape) == tuple(other)
        return (isinstance(other, DataDesc) and self.name == other.name
                and self.shape == other.shape)

    __hash__ = object.__hash__


class DataBatch:
    """One minibatch of data and label arrays."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        def listify(x):
            return x if x is None or isinstance(x, (list, tuple)) else [x]
        self.data, self.label = listify(data), listify(label)
        self.pad, self.index = pad, index
        self.bucket_key = bucket_key
        self.provide_data, self.provide_label = provide_data, provide_label


class DataIter:
    """Iterator protocol: subclasses implement ``iter_next``, ``getdata``,
    ``getlabel`` and ``getpad``; ``next`` assembles the DataBatch."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def reset(self):
        pass

    def next(self):
        if not self.iter_next():
            raise StopIteration
        return DataBatch(data=self.getdata(), label=self.getlabel(),
                         pad=self.getpad(), index=self.getindex())

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()


class _BatchView(DataIter):
    """An iterator that serves a held ``current_batch``."""

    current_batch = None

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class ResizeIter(_BatchView):
    """An iterator presented as exactly ``size`` batches a epoch, the
    source rewound whenever it runs out."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur >= self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True


class _Slot:
    """One producer thread that keeps one batch of ``source`` ready: it
    fills ``batch`` whenever ``vacant`` is set, then sets ``ready``; the
    end of the source is ``batch`` None."""

    def __init__(self, source):
        self.source = source
        self.ready = threading.Event()
        self.vacant = threading.Event()
        self.vacant.set()
        self.batch = None
        self.error = None
        self.live = True
        self.thread = threading.Thread(target=self._produce, daemon=True)
        self.thread.start()

    def _produce(self):
        while True:
            self.vacant.wait()
            if not self.live:
                return
            try:
                self.batch = self.source.next()
            except StopIteration:
                self.batch = None
            except Exception as e:   # handed to the consumer's thread
                self.batch, self.error = None, e
            self.vacant.clear()
            self.ready.set()

    def take(self):
        """The held batch (None at the end); raises what the source
        raised."""
        self.ready.wait()
        if self.error is not None:
            error, self.error = self.error, None
            raise error
        return self.batch

    def release(self):
        """Hand the held batch over; the producer fills the next."""
        self.ready.clear()
        self.vacant.set()

    def reset(self):
        self.ready.wait()          # let a fill in flight land
        self.error = None
        self.source.reset()
        self.release()

    def shutdown(self):
        self.live = False
        self.vacant.set()


class PrefetchingIter(_BatchView):
    """Prefetches one batch ahead from each of one or more iterators on
    threads of their own, and merges their batches into one DataBatch a
    step (names renamed through ``rename_data``/``rename_label``, a dict
    per source)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        sources = iters if isinstance(iters, list) else [iters]
        if not sources:
            raise ValueError("need at least one source iterator")
        self.iters = sources
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self._slots = [_Slot(src) for src in sources]

    def __del__(self):
        for slot in getattr(self, "_slots", ()):
            slot.shutdown()

    @staticmethod
    def _described(per_iter_descs, renames):
        if renames is None:
            return sum(per_iter_descs, [])
        renamed = []
        for mapping, descs in zip(renames, per_iter_descs):
            for d in descs:
                if isinstance(d, DataDesc):
                    renamed.append(DataDesc(mapping[d.name], d.shape,
                                            d.dtype))
                else:
                    renamed.append(DataDesc(mapping[d[0]], d[1]))
        return renamed

    @property
    def provide_data(self):
        return self._described([it.provide_data for it in self.iters],
                               self.rename_data)

    @property
    def provide_label(self):
        return self._described([it.provide_label for it in self.iters],
                               self.rename_label)

    def reset(self):
        for slot in self._slots:
            slot.reset()

    def iter_next(self):
        parts = [slot.take() for slot in self._slots]
        if parts[0] is None:
            return False
        self.current_batch = DataBatch(
            sum((b.data for b in parts), []),
            sum((b.label for b in parts), []),
            parts[0].pad, parts[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        for slot in self._slots:
            slot.release()
        return True

    def next(self):
        if not self.iter_next():
            raise StopIteration
        return self.current_batch


def _init_data(data, allow_empty, default_name):
    """Array / list / dict input -> [(name, host numpy array), ...]; a
    numpy float64 array becomes float32, an NDArray keeps its dtype (a
    bfloat16 one is read as float32, which numpy lacks), as in the JAX
    package (``mxnet_tpu/io.py:389-396``)."""
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not data and not allow_empty:
            raise ValueError("empty data")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    pairs = []
    for name, arr in data.items():
        if isinstance(arr, NDArray):
            raw = arr.asnumpy()
        else:
            raw = np.asarray(arr)
            if raw.dtype == np.float64:
                raw = raw.astype(np.float32)
        pairs.append((name, raw))
    return pairs


class NDArrayIter(DataIter):
    """Batches over in-memory arrays."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        total = self.data[0][1].shape[0]
        self.idx = np.arange(total)
        if shuffle:
            _random.host_rng().shuffle(self.idx)
        if last_batch_handle == "discard":
            self.idx = self.idx[:total - total % batch_size]
        self.num_data = self.idx.shape[0]
        if self.num_data < batch_size:
            raise ValueError("batch_size needs to be smaller than data size.")
        self.cursor = -batch_size

    @property
    def provide_data(self):
        return [DataDesc(name, (self.batch_size,) + arr.shape[1:], arr.dtype)
                for name, arr in self.data]

    @property
    def provide_label(self):
        return [DataDesc(name, (self.batch_size,) + arr.shape[1:], arr.dtype)
                for name, arr in self.label]

    def reset(self):
        if self.shuffle:
            _random.host_rng().shuffle(self.idx)
        if self.last_batch_handle == "roll_over" \
                and self.cursor > self.num_data:
            overhang = (self.cursor % self.num_data) % self.batch_size
            self.cursor = overhang - self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _window(self):
        """Indices of the current batch, wrapping the tail if short."""
        lo, hi = self.cursor, self.cursor + self.batch_size
        if hi <= self.num_data:
            return self.idx[lo:hi]
        return np.concatenate([self.idx[lo:], self.idx[:hi - self.num_data]])

    def _slice(self, source):
        if self.cursor >= self.num_data:
            raise RuntimeError("DataIter needs reset.")
        sel = self._window()
        return [nd.array(host[sel], ctx=cpu(), dtype=host.dtype)
                for _, host in source]

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self):
        overrun = self.cursor + self.batch_size - self.num_data
        if self.last_batch_handle == "pad" and overrun > 0:
            return overrun
        return 0


class _WrappedArrayIter(DataIter):
    """CSVIter's and MNISTIter's shell: parse the files once, then serve
    them through an inner NDArrayIter."""

    def __init__(self, data, label, batch_size, **iter_kwargs):
        super().__init__(batch_size)
        self._inner = NDArrayIter(data, label, batch_size, **iter_kwargs)
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class CSVIter(_WrappedArrayIter):
    """Batches of a comma-separated file (reference
    ``src/io/iter_csv.cc:150``); without ``label_csv`` the labels are 0."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        table = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        table = table.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if tuple(label_shape) == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros((table.shape[0],), dtype=np.float32)
        super().__init__(table, label, batch_size,
                         last_batch_handle="roll_over" if round_batch
                         else "pad")


def _read_idx_file(path):
    """An MNIST idx file as uint8 numpy: magic 2051 images (N, rows,
    cols), 2049 labels (N,)."""
    with open(path, "rb") as fh:
        magic, count = struct.unpack(">ii", fh.read(8))
        if magic == 2051:
            rows, cols = struct.unpack(">ii", fh.read(8))
            return np.frombuffer(fh.read(), dtype=np.uint8) \
                .reshape(count, rows, cols)
        if magic == 2049:
            return np.frombuffer(fh.read(), dtype=np.uint8).reshape(count)
        raise MXNetError("bad idx magic %d in %s" % (magic, path))


def write_idx_file(path, array):
    """Write uint8 ``array`` as an idx file: (N, rows, cols) images or
    (N,) labels, the format ``MNISTIter`` reads."""
    array = np.ascontiguousarray(array, dtype=np.uint8)
    with open(path, "wb") as fh:
        if array.ndim == 3:
            fh.write(struct.pack(">iiii", 2051, *array.shape))
        elif array.ndim == 1:
            fh.write(struct.pack(">ii", 2049, array.shape[0]))
        else:
            raise MXNetError("an idx file holds (N, rows, cols) images or "
                             "(N,) labels, not shape %s" % (array.shape,))
        fh.write(array.tobytes())


class MNISTIter(_WrappedArrayIter):
    """Batches of MNIST's idx files (reference ``src/io/iter_mnist.cc:259``):
    images scaled to [0, 1], (N, 1, 28, 28) or with ``flat`` (N, 784);
    shuffled from ``random.host_rng``."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128, shuffle=True,
                 flat=False, silent=False, seed=0, input_shape=None, **kwargs):
        if not os.path.exists(image):
            raise MXNetError("MNIST file %s not found" % image)
        pixels = _read_idx_file(image).astype(np.float32) / 255.0
        digits = _read_idx_file(label).astype(np.float32)
        if flat:
            pixels = pixels.reshape(pixels.shape[0], -1)
        else:
            pixels = pixels.reshape(pixels.shape[0], 1, 28, 28)
        super().__init__(pixels, digits, batch_size, shuffle=shuffle)


def _read_libsvm(path):
    """A LibSVM file's lines (reference ``src/io/iter_libsvm.cc:200``;
    ``label idx:val ...``, ids 0-based) as (labels, rows, ids, values,
    count of lines): the entries in file order, the last value of an id
    repeated in a line, values through ``float``."""
    labels, rows, ids, values = [], [], [], []
    with open(path) as fh:
        for line in fh:
            cells = line.split()
            if not cells:
                continue
            row = {}
            for tok in cells[1:]:
                idx, _, val = tok.partition(":")
                row[int(idx)] = float(val)
            rows.extend([len(labels)] * len(row))
            ids.extend(row)
            values.extend(row.values())
            labels.append(float(cells[0]))
    return (np.asarray(labels, np.float32), np.asarray(rows, np.int64),
            np.asarray(ids, np.int64), np.asarray(values, np.float32),
            len(labels))


def _in_width(ids, dim, path):
    """The ids below ``dim``, a negative one counted from the end as the
    JAX package's dense write counts it."""
    if ids.size and ids.min() < -dim:
        raise MXNetError("%s: feature id %d is out of range for width %d"
                         % (path, ids.min(), dim))
    keep = ids < dim
    return np.where(ids < 0, ids + dim, ids), keep


def _parse_libsvm_csr(path, dim):
    """(labels, canonical CSR parts (values, ids, row pointers)): ids at
    or past ``dim`` dropped, zeros dropped, ids sorted in each row."""
    labels, rows, ids, values, n = _read_libsvm(path)
    ids, keep = _in_width(ids, dim, path)
    rows, ids, values = rows[keep], ids[keep], values[keep]
    # the last write of a (line, column) wins; np.unique sorts the keys
    flat = rows * max(dim, 1) + ids
    _, last = np.unique(flat[::-1], return_index=True)
    sel = flat.size - 1 - last
    sel = sel[values[sel] != 0]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows[sel], minlength=n), out=indptr[1:])
    return labels, (values[sel], ids[sel], indptr)


def _parse_libsvm_dense(path, dim=None):
    """A (label) LibSVM file as the JAX package's ``_parse_libsvm`` gives
    it, a dense float32 matrix (width ``dim``, else the largest id + 1)."""
    labels, rows, ids, values, n = _read_libsvm(path)
    if dim is None:
        dim = int(ids.max()) + 1 if ids.size else 0
    ids, keep = _in_width(ids, dim, path)
    dense = np.zeros((n, dim), np.float32)
    dense[rows[keep], ids[keep]] = values[keep]
    return dense, labels


class LibSVMIter(DataIter):
    """Batches of a LibSVM file as CSR arrays (reference
    ``src/io/iter_libsvm.cc:200``): ``data_shape`` is the feature width
    (its product), the labels are each line's first value, or the rows
    of ``label_libsvm`` shaped ``label_shape``.  ``round_batch`` True
    carries the tail into the next epoch (``roll_over``), False wraps it
    and reports the pad (``pad``), with the JAX package's batches, pads
    and order.  Each batch is canonical: zeros dropped, ids sorted."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=None, batch_size=1, round_batch=True,
                 **kwargs):
        super().__init__(batch_size)
        self._dim = int(np.prod(data_shape))
        labels, self._parts = _parse_libsvm_csr(data_libsvm, self._dim)
        if label_libsvm is not None:
            lab_dim = int(np.prod(label_shape)) if label_shape else None
            labels, _ = _parse_libsvm_dense(label_libsvm, lab_dim)
            if label_shape:
                labels = labels.reshape((-1,) + tuple(label_shape))
        self._inner = NDArrayIter(
            np.arange(self._parts[2].size - 1, dtype=np.int64), labels,
            batch_size, last_batch_handle="roll_over" if round_batch
            else "pad")
        self.provide_data = [DataDesc("data", (batch_size, self._dim),
                                      np.float32)]
        self.provide_label = self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def _csr_rows(self, rows):
        """The CSR of the file's ``rows``, on the host; its parts in pinned
        memory where there is a card, so their copy into a step's buffers
        on the card does not wait."""
        values, ids, indptr = self._parts
        starts = indptr[rows]
        lengths = indptr[rows + 1] - starts
        bptr = np.zeros(rows.size + 1, np.int64)
        np.cumsum(lengths, out=bptr[1:])
        take = np.repeat(starts - bptr[:-1], lengths) + np.arange(bptr[-1])
        parts = [torch.from_numpy(a) for a in (values[take], ids[take], bptr)]
        if torch.cuda.is_available():
            parts = [p.pin_memory() for p in parts]
        return CSRNDArray(CSR(*parts, (rows.size, self._dim)), cpu())

    def next(self):
        batch = self._inner.next()
        batch.data = [self._csr_rows(batch.data[0].asnumpy())]
        return batch
