"""Gluon vision datasets.

Counterpart of ``mxnet_tpu/gluon/data/vision.py`` (``_synthetic``:26,
``MNIST``:33, ``FashionMNIST``:74, ``CIFAR10``:83, ``CIFAR100``:126,
``ImageRecordDataset``:155, ``ImageFolderDataset``:173): the files under
``root`` in their published formats (MNIST's gzipped idx files, CIFAR's
binary batches) where present, else the JAX package's seeded synthetic
fixture, equal to it bit for bit.  Images are HWC host NDArrays; a
record or folder image decodes through ``image.imdecode`` on the context
current where the dataset was built (nvJPEG on a card, libjpeg on
``cpu()``), also in a ``DataLoader``'s worker threads, which a ``with
ctx:`` block of the caller does not reach.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from .dataset import _DownloadedDataset, RecordFileDataset
from ... import ndarray as nd
from ...context import cpu, current_context
from ... import image as _image_mod
from ... import recordio

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


def _synthetic(num, shape, num_classes, seed):
    rng = np.random.RandomState(seed)
    data = rng.randint(0, 256, size=(num,) + shape).astype(np.uint8)
    label = rng.randint(0, num_classes, size=(num,)).astype(np.int32)
    return data, label


class MNIST(_DownloadedDataset):
    """MNIST.  Reads idx-ubyte files if present
    under root, else synthesizes a small fixture."""

    _train_files = ("train-images-idx3-ubyte.gz",
                    "train-labels-idx1-ubyte.gz")
    _test_files = ("t10k-images-idx3-ubyte.gz",
                   "t10k-labels-idx1-ubyte.gz")
    _synth_num = 1024

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "mnist"),
                 train=True, transform=None):
        super(MNIST, self).__init__(root, train, transform)

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        data_file = os.path.join(self._root, files[0])
        label_file = os.path.join(self._root, files[1])
        if os.path.isfile(data_file) and os.path.isfile(label_file):
            with gzip.open(label_file, "rb") as fin:
                struct.unpack(">II", fin.read(8))
                label = np.frombuffer(fin.read(), dtype=np.uint8) \
                    .astype(np.int32)
            with gzip.open(data_file, "rb") as fin:
                struct.unpack(">IIII", fin.read(16))
                data = np.frombuffer(fin.read(), dtype=np.uint8)
                data = data.reshape(len(label), 28, 28, 1)
        else:
            data, label = _synthetic(self._synth_num, (28, 28, 1), 10,
                                     42 if self._train else 43)
        self._label = label
        self._data = nd.array(data, ctx=cpu(), dtype=np.uint8)

    def __getitem__(self, idx):
        data = self._data[idx].astype(np.float32)
        if self._transform is not None:
            return self._transform(data, self._label[idx])
        return data, self._label[idx]


class FashionMNIST(MNIST):
    """FashionMNIST; same file format."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super(FashionMNIST, self).__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10.  Reads the binary batch files
    if present, else synthesizes."""

    _synth_num = 1024
    _num_classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        super(CIFAR10, self).__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            raw = np.frombuffer(fin.read(), dtype=np.uint8)
        rec = raw.reshape(-1, 3072 + 1)
        return rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            rec[:, 0].astype(np.int32)

    def _get_data(self):
        if self._train:
            files = ["data_batch_%d.bin" % i for i in range(1, 6)]
        else:
            files = ["test_batch.bin"]
        paths = [os.path.join(self._root, f) for f in files]
        if all(os.path.isfile(p) for p in paths):
            parts = [self._read_batch(p) for p in paths]
            data = np.concatenate([p[0] for p in parts])
            label = np.concatenate([p[1] for p in parts])
        else:
            data, label = _synthetic(self._synth_num, (32, 32, 3),
                                     self._num_classes,
                                     44 if self._train else 45)
        self._data = nd.array(data, ctx=cpu(), dtype=np.uint8)
        self._label = label

    def __getitem__(self, idx):
        data = self._data[idx].astype(np.float32)
        if self._transform is not None:
            return self._transform(data, self._label[idx])
        return data, self._label[idx]


class CIFAR100(CIFAR10):
    """CIFAR100."""

    _num_classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super(CIFAR100, self).__init__(root, train, transform)

    def _get_data(self):
        files = ["train.bin"] if self._train else ["test.bin"]
        paths = [os.path.join(self._root, f) for f in files]
        if all(os.path.isfile(p) for p in paths):
            with open(paths[0], "rb") as fin:
                raw = np.frombuffer(fin.read(), dtype=np.uint8)
            rec = raw.reshape(-1, 3072 + 2)
            data = rec[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            label = rec[:, 1 if self._fine_label else 0].astype(np.int32)
        else:
            data, label = _synthetic(
                self._synth_num, (32, 32, 3),
                100 if self._fine_label else 20,
                46 if self._train else 47)
        self._data = nd.array(data, ctx=cpu(), dtype=np.uint8)
        self._label = label


class ImageRecordDataset(RecordFileDataset):
    """Images packed in a RecordIO file."""

    def __init__(self, filename, flag=1, transform=None):
        super(ImageRecordDataset, self).__init__(filename)
        self._flag = flag
        self._transform = transform
        self._ctx = current_context()

    def __getitem__(self, idx):
        record = super(ImageRecordDataset, self).__getitem__(idx)
        header, img = recordio.unpack(record)
        img = _image_mod.imdecode(img, self._flag, ctx=self._ctx)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(_DownloadedDataset):
    """A dataset of images arranged in class folders
   ."""

    def __init__(self, root, flag=1, transform=None):
        self._flag = flag
        self._ctx = current_context()
        self._exts = [".jpg", ".jpeg", ".png"]
        # note: bypasses _DownloadedDataset synthesis - folder must exist
        self._root = os.path.expanduser(root)
        self._transform = transform
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    continue
                self.items.append((filename, float(label)))

    def __getitem__(self, idx):
        with open(self.items[idx][0], "rb") as f:
            img = _image_mod.imdecode(f.read(), self._flag, ctx=self._ctx)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
