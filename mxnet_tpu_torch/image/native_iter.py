"""``ImageRecordIter``: the threaded .rec decode pipeline.

Counterpart of ``mxnet_tpu/image/native_iter.py`` (``ImageRecordIter``:50,
the reference's ``src/io/iter_image_recordio_2.cc``): record indexing,
JPEG decode, bilinear resize to ``data_shape``, the random mirror and
batch assembly run in native worker threads (``preprocess_threads``), one
batch prefetched; the iterator gives host (``cpu()``) NDArrays, float32
NCHW in [0, 1], less ``mean_rgb`` / 255 and times ``scale`` where given,
each batch in a buffer of its own (pinned on the card's route).

The decoder follows ``ctx`` (by default the current context, so the
card):

- ``cpu()``: libjpeg on host threads, ``_native/csrc/image_loader.cc``,
  the package's copy of the JAX package's loader, then the mean and the
  scale in numpy: the same batches, bit for bit, from the same file and
  seed;
- ``gpu(i)``: nvJPEG on card i (``ops/csrc/image_nvjpeg.cu``): the host
  threads read the records and run nvJPEG's Huffman stage, the card the
  rest; then one launch a round of the resize kernel
  (``ops.image_nvjpeg``) writes every image the round decoded, less the
  mean and times the scale, into the batch on the card, failed records
  compacted out there, and the batch is copied once, from the card into
  its pinned host buffer.  The same records, order and mirror draws as
  the host loader, the same arithmetic after the decode, pixels within
  nvJPEG's decode of libjpeg's.

A decoder that cannot be built or loaded raises ``MXNetError`` naming
it; there is no fallback to the other.  A record that fails to decode
raises ``IOError``, or with ``allow_corrupt=True`` is dropped from its
batch, which the records that follow top up (``num_failed`` counts
them).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import io as _io
from .. import ndarray as nd
from .. import profiler
from .. import _native
from ..base import MXNetError
from ..context import as_context, cpu
from ..ops import image_nvjpeg

__all__ = ["ImageRecordIter"]

_FLOATS = ctypes.POINTER(ctypes.c_float)


class _HostLoader:
    """libjpeg on host threads (``mx_imgloader_*``), then the mean and the
    scale in numpy (the JAX package's order)."""

    decoder = "libjpeg"

    def __init__(self, path, batch_size, shape, threads, shuffle, seed,
                 mirror, mean, scale, ctx):
        try:
            self._lib = _native.image_lib()
        except MXNetError as e:
            raise MXNetError("ImageRecordIter on the CPU decodes with "
                             "libjpeg (_native/csrc/image_loader.cc), which "
                             "could not be built or loaded: %s" % e) from e
        c, h, w = shape
        self._h = self._lib.mx_imgloader_create(
            str(path).encode(), batch_size, h, w, c, threads, shuffle, seed,
            mirror)
        if not self._h:
            raise IOError("cannot open record file %s" % path)
        self._mean = None if mean is None else mean.reshape(1, -1, 1, 1)
        self._scale = scale

    def num_samples(self):
        return self._lib.mx_imgloader_num_samples(self._h)

    def failures(self):
        return self._lib.mx_imgloader_failures(self._h)

    def reset(self):
        self._lib.mx_imgloader_reset(self._h)

    def next(self, data, labels):
        n = self._lib.mx_imgloader_next(
            self._h, ctypes.cast(data.data_ptr(), _FLOATS),
            ctypes.cast(labels.data_ptr(), _FLOATS))
        arr = data.numpy()
        if self._mean is not None:
            arr -= self._mean
        if self._scale is not None:
            arr *= np.float32(self._scale)
        return n, self._lib.mx_imgloader_last_failed(self._h)

    def close(self):
        if self._h:
            self._lib.mx_imgloader_destroy(self._h)
            self._h = None


class _CardLoader:
    """nvJPEG on one card (``mx_nvjpeg_*``); the mean and the scale in the
    resize kernel."""

    decoder = "nvjpeg"

    def __init__(self, path, batch_size, shape, threads, shuffle, seed,
                 mirror, mean, scale, ctx):
        try:
            self._lib = image_nvjpeg.loader_lib()
        except MXNetError as e:
            raise MXNetError("ImageRecordIter on %s decodes with nvJPEG "
                             "(ops/csrc/image_nvjpeg.cu), which could not be "
                             "built or loaded: %s" % (ctx, e)) from e
        c, h, w = shape
        if mean is not None:
            mean = image_nvjpeg.channel_mean(mean, c)
        err = ctypes.create_string_buffer(512)
        self._h = self._lib.mx_nvjpeg_create(
            str(path).encode(), batch_size, h, w, c, threads, shuffle, seed,
            mirror, None if mean is None else mean.ctypes.data,
            0.0 if scale is None else float(np.float32(scale)),
            int(scale is not None), ctx.device_id, err, len(err))
        if not self._h:
            msg = err.value.decode(errors="replace")
            if msg.startswith(("cannot open", "no records")):
                raise IOError(msg)
            raise MXNetError("ImageRecordIter: nvJPEG on %s failed: %s"
                             % (ctx, msg))
        self._launches = self._rounds = 0

    def num_samples(self):
        return self._lib.mx_nvjpeg_num_samples(self._h)

    def failures(self):
        return self._lib.mx_nvjpeg_failures(self._h)

    def reset(self):
        self._lib.mx_nvjpeg_reset(self._h)

    def next(self, data, labels):
        n = self._lib.mx_nvjpeg_next(
            self._h, ctypes.cast(data.data_ptr(), _FLOATS),
            ctypes.cast(labels.data_ptr(), _FLOATS))
        launches = self._lib.mx_nvjpeg_launches(self._h)
        rounds = self._lib.mx_nvjpeg_rounds(self._h)
        profiler.bump(image_nvjpeg.COUNTER, launches - self._launches)
        profiler.bump(image_nvjpeg.ROUNDS_COUNTER, rounds - self._rounds)
        self._launches, self._rounds = launches, rounds
        if n < 0:
            raise MXNetError("ImageRecordIter: nvJPEG decode failed: %s"
                             % self._lib.mx_nvjpeg_error(self._h).decode(
                                 errors="replace"))
        return n, self._lib.mx_nvjpeg_last_failed(self._h)

    def close(self):
        if self._h:
            self._lib.mx_nvjpeg_destroy(self._h)
            self._h = None


class ImageRecordIter(_io.DataIter):
    """Batches of a .rec file of JPEG records: data (batch, c, h, w)
    float32 and scalar labels (the first of a record's labels), both on
    ``cpu()``; ``pad`` counts the tail slots past the end of the data."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 shuffle=False, preprocess_threads=4, rand_mirror=False,
                 seed=0, mean_rgb=None, scale=None, data_name="data",
                 label_name="softmax_label", allow_corrupt=False, ctx=None,
                 **kwargs):
        super().__init__(batch_size)
        ctx = as_context(ctx)
        self.data_shape = tuple(int(d) for d in data_shape)
        self._allow_corrupt = bool(allow_corrupt)
        loader = _HostLoader if ctx.device_type != "gpu" else _CardLoader
        mean = None if mean_rgb is None else \
            np.asarray(mean_rgb, np.float32) / 255.0
        self._loader = loader(path_imgrec, batch_size, self.data_shape,
                              int(preprocess_threads), int(bool(shuffle)),
                              int(seed), int(bool(rand_mirror)), mean, scale,
                              ctx)
        self.decoder = self._loader.decoder
        # the card's batches go to the card: each is written straight into
        # a pinned buffer of its own (torch's caching host allocator), which
        # the batch owns, so none is overwritten while a copy reads it
        self._pinned = self.decoder == "nvjpeg"
        self.provide_data = [_io.DataDesc(data_name,
                                          (batch_size,) + self.data_shape)]
        self.provide_label = [_io.DataDesc(label_name, (batch_size,))]

    @property
    def num_samples(self):
        return int(self._loader.num_samples())

    @property
    def num_failed(self):
        """Records dropped for a failed decode so far (they grow only with
        ``allow_corrupt=True``; otherwise ``next`` raises)."""
        return int(self._loader.failures())

    def reset(self):
        self._loader.reset()

    def next(self):
        data = torch.empty((self.batch_size,) + self.data_shape,
                           dtype=torch.float32, pin_memory=self._pinned)
        labels = torch.empty((self.batch_size,), dtype=torch.float32)
        n, fresh = self._loader.next(data, labels)
        if fresh and not self._allow_corrupt:
            raise IOError(
                "%d record(s) failed to decode (corrupt or non-JPEG "
                "payload); pass allow_corrupt=True to skip them" % fresh)
        if n == 0:
            raise StopIteration
        return _io.DataBatch([nd.NDArray(data, cpu())],
                             [nd.NDArray(labels, cpu())],
                             pad=self.batch_size - n)

    def __del__(self):
        loader = getattr(self, "_loader", None)
        if loader is not None:
            loader.close()
