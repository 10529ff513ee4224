"""Gluon datasets.

Counterpart of ``mxnet_tpu/gluon/data/dataset.py`` (``Dataset``:13 with
the lazy ``transform``, ``SimpleDataset``:37, ``ArrayDataset``:63,
``RecordFileDataset``:88, ``_DownloadedDataset``:102).  A downloaded
dataset reads its files under ``root`` where they are, else draws a
seeded synthetic fixture (nothing is downloaded), and creates no
directory.
"""
from __future__ import annotations

import os

from ... import ndarray as nd
from ... import recordio

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset",
           "RecordFileDataset", "_DownloadedDataset"]


class Dataset(object):
    """Abstract dataset: needs ``__getitem__`` and ``__len__``
    ."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)
        return self.transform(base_fn, lazy)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Dataset zipping multiple array-likes."""

    def __init__(self, *args):
        assert len(args) > 0, "Needs at least 1 arrays"
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                "All arrays must have the same length; array[0] has " \
                "length %d while array[%d] has %d." \
                % (self._length, i, len(data))
            if isinstance(data, nd.NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO (.rec) file."""

    def __init__(self, filename):
        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)


class _DownloadedDataset(Dataset):
    """Base of the MNIST- and CIFAR-style datasets: their files under
    ``root`` if present, else a seeded synthetic fixture."""

    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError
