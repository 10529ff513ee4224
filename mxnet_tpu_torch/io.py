"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter`` and
``NDArrayIter``.

Counterpart of ``mxnet_tpu/io.py`` (``DataDesc`` :67, ``DataBatch``
:106, ``DataIter`` :119, ``_init_data`` :372, ``NDArrayIter`` :400):
``last_batch_handle`` ``pad`` (wrap the tail batch around and report the
pad), ``discard`` (drop it) or ``roll_over`` (carry it into the next
epoch); ``shuffle`` draws from the framework's host generator
(``random.host_rng``), so a seeded shuffle gives the JAX package's
order.  As in MXNet the batches are staged in host memory (NDArrays on
``cpu()``): the executor copies each into its bound arrays on the card.
The record, image, CSV and MNIST iterators are not ported yet.
"""
from __future__ import annotations

import numpy as np

from .context import cpu
from . import ndarray as nd
from . import random as _random
from .ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


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


def _init_data(data, allow_empty, default_name):
    """Array / list / dict input -> [(name, host numpy array), ...];
    float64 becomes float32."""
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
        raw = arr.asnumpy() if isinstance(arr, NDArray) else np.asarray(arr)
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
