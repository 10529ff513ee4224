"""Data helpers: the synthetic-digits stand-in for MNIST.

This package's own copy of the recipe in ``mxnet_tpu/test_utils.py:396-434``
(numpy only, so the arrays are equal bit for bit): ``RandomState(42)``,
10 prototype images, 4096 train and 1024 test images of prototype plus
N(0, 0.3) noise clipped to [0, 1], labels as float32.  The real MNIST
idx files are not in the repository; reading them is not ported.
"""
from __future__ import annotations

import numpy as np

__all__ = ["get_mnist"]


def _synthetic_digits(n, rng, protos):
    labels = rng.randint(0, 10, n)
    images = protos[labels] + rng.normal(0, 0.3, (n, 28, 28)).astype(
        np.float32)
    return np.clip(images, 0.0, 1.0)[:, None, :, :], labels.astype(
        np.float32)


def get_mnist():
    """dict(train_data, train_label, test_data, test_label); images NCHW
    float32 in [0, 1]."""
    rng = np.random.RandomState(42)
    protos = rng.rand(10, 28, 28).astype(np.float32)
    tr_x, tr_y = _synthetic_digits(4096, rng, protos)
    te_x, te_y = _synthetic_digits(1024, rng, protos)
    return {"train_data": tr_x, "train_label": tr_y,
            "test_data": te_x, "test_label": te_y}
