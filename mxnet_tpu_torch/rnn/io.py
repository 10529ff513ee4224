"""Bucketed sentence iterator of ``mx.rnn``.

Counterpart of ``mxnet_tpu/rnn/io.py``: ``encode_sentences`` and
``BucketSentenceIter``, which pads each sentence into the smallest bucket
that holds it and serves (batch, bucket) batches with the next-token
labels, ``invalid_label`` where padded.  Both shuffles (rows within a
bucket, then the order of the batches) draw from ``random.host_rng()``,
so after ``random.seed(n)`` in both packages the iterators yield the same
batches in the same order.  Batches are NDArrays on ``cpu()``, as
``NDArrayIter``'s are.
"""
from __future__ import annotations

import bisect
import logging

import numpy as np

from .. import ndarray as nd
from .. import random as _random
from ..context import cpu
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Map token sequences to integer ids, growing *vocab* as needed
    (ref rnn/io.py:encode_sentences)."""
    if vocab is None:
        vocab = {invalid_key: invalid_label}
    next_id = start_label
    taken = set(vocab.values())
    encoded = []
    for sent in sentences:
        row = []
        for word in sent:
            if word not in vocab:
                while next_id in taken:
                    next_id += 1
                vocab[word] = next_id
                taken.add(next_id)
            row.append(vocab[word])
        encoded.append(row)
    return encoded, vocab


def _default_buckets(sentences, count=5):
    """Pick bucket lengths from the sentence-length distribution."""
    lengths = sorted(len(s) for s in sentences if s)
    if not lengths:
        return []
    qs = sorted({lengths[min(len(lengths) - 1,
                             int(len(lengths) * q / count))]
                 for q in range(1, count + 1)})
    return qs


class BucketSentenceIter(DataIter):
    """Pads each sentence into the smallest bucket that fits and serves
    fixed-shape batches per bucket (ref rnn/io.py:BucketSentenceIter).

    Labels are the next-token shift of the data, padded with
    ``invalid_label``.
    """

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        self.data_name, self.label_name = data_name, label_name
        self.dtype = dtype
        self.layout = layout
        self.invalid_label = invalid_label
        if buckets is None:
            buckets = _default_buckets(sentences)
        self.buckets = sorted(buckets)

        # per-bucket padded data matrices
        per_bucket = [[] for _ in self.buckets]
        discarded = 0
        for sent in sentences:
            if not sent:
                continue
            slot = bisect.bisect_left(self.buckets, len(sent))
            if slot == len(self.buckets):
                discarded += 1
                continue
            padded = np.full(self.buckets[slot], invalid_label,
                             dtype=self.dtype)
            padded[:len(sent)] = sent
            per_bucket[slot].append(padded)
        if discarded:
            logging.warning("discarded %d sentences longer than the largest "
                            "bucket", discarded)
        self.data = [np.asarray(rows, dtype=self.dtype) if rows
                     else np.zeros((0, b), dtype=self.dtype)
                     for rows, b in zip(per_bucket, self.buckets)]

        self.batch_size = batch_size
        self.default_bucket_key = max(self.buckets)
        self._plan = []          # (bucket_idx, row_offset) per batch
        self._order = None
        self.major_axis = layout.find("N")
        self.provide_data = [DataDesc(
            data_name, self._shape_for(self.default_bucket_key),
            layout=layout)]
        self.provide_label = [DataDesc(
            label_name, self._shape_for(self.default_bucket_key),
            layout=layout)]
        self.idx = None
        self.reset()

    def _shape_for(self, seq_len):
        if self.major_axis == 0:
            return (self.batch_size, seq_len)
        return (seq_len, self.batch_size)

    def reset(self):
        # both shuffles draw from the host generator, so random.seed
        # makes the epoch's order reproducible
        rng = _random.host_rng()
        self._plan = []
        for b, rows in enumerate(self.data):
            rng.shuffle(rows)               # row order within bucket
            for start in range(0, len(rows) - self.batch_size + 1,
                               self.batch_size):
                self._plan.append((b, start))
        order = rng.permutation(len(self._plan))
        self._plan = [self._plan[i] for i in order]
        self._cursor = 0

    def next(self):
        if self._cursor >= len(self._plan):
            raise StopIteration
        bucket_idx, start = self._plan[self._cursor]
        self._cursor += 1
        rows = self.data[bucket_idx][start:start + self.batch_size]
        seq_len = self.buckets[bucket_idx]

        labels = np.full_like(rows, self.invalid_label)
        labels[:, :-1] = rows[:, 1:]
        if self.major_axis == 1:      # TN layout
            rows, labels = rows.T, labels.T

        return DataBatch(
            [nd.array(rows, ctx=cpu())], [nd.array(labels, ctx=cpu())],
            pad=0,
            bucket_key=seq_len,
            provide_data=[DataDesc(self.data_name, rows.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, labels.shape,
                                    layout=self.layout)])
