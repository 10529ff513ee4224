"""Gluon ``DataLoader``.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py``
(``default_batchify_fn``:22, ``DataLoader``:33): samples batched on the
host into ``cpu()`` NDArrays; ``num_workers`` > 0 fills batches on a
background thread, up to ``max(2, num_workers)`` ahead.
"""
from __future__ import annotations

import threading
import queue as _queue

import numpy as np

from ... import ndarray as nd
from ...context import cpu
from .sampler import SequentialSampler, RandomSampler, BatchSampler

__all__ = ["DataLoader"]


def default_batchify_fn(data):
    """Stack a list of samples into a batch."""
    if isinstance(data[0], nd.NDArray):
        return nd.stack(*data)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = np.asarray(data)
    return nd.array(data, ctx=cpu(), dtype=data.dtype)


class DataLoader(object):
    """Loads data from a Dataset and returns mini-batches."""

    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler "
                    "is specified")
            if sampler is None:
                if shuffle:
                    sampler = RandomSampler(len(dataset))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is "
                    "specified")
            batch_sampler = BatchSampler(
                sampler, batch_size, last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers  # prefetch depth (thread-based)

    def __iter__(self):
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield self._batchify_fn(
                    [self._dataset[idx] for idx in batch])
            return
        # background-thread prefetch pipeline
        q = _queue.Queue(maxsize=max(2, self._num_workers))
        sentinel = object()

        def worker():
            try:
                for batch in self._batch_sampler:
                    q.put(self._batchify_fn(
                        [self._dataset[idx] for idx in batch]))
                q.put(sentinel)
            except BaseException as exc:  # propagate to the consumer
                q.put(exc)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def __len__(self):
        return len(self._batch_sampler)
