"""``Pooling(pool_type="lp")`` of the PyTorch package against the JAX
package on the CPU: ``(sum |x|^p)^(1/p)`` over each window, at p_value 1,
2 and 3, in the ``valid`` and ``full`` conventions and as a global pool,
forward and the gradient under a seeded head gradient.

Tolerance: fp32 atol 1e-5 and rtol 1e-5, as
``tests/test_torch_conv_bn_pool.py`` holds the other pools (the same
arithmetic, the window sums taken in other orders).
"""
import importlib.util
import itertools
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


conv_bn_pool = _load("test_torch_conv_bn_pool",
                     "tests/test_torch_conv_bn_pool.py")


@pytest.mark.parametrize("p_value,convention,window", list(itertools.product(
    (1, 2, 3), ("valid", "full"), conv_bn_pool.POOL_WINDOWS)))
def test_lp_pooling(p_value, convention, window):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 9, 11).astype(np.float32)
    kernel, stride, pad = window
    got, _ = conv_bn_pool._check("Pooling", [x], dict(
        kernel=kernel, stride=stride, pad=pad, pool_type="lp",
        p_value=p_value, pooling_convention=convention), [0])
    if convention == "full" and window == conv_bn_pool.POOL_WINDOWS[1]:
        assert got[0].shape == (2, 3, 5, 6)


@pytest.mark.parametrize("p_value", [1, 2, 3])
def test_lp_global_pooling(p_value):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 4, 7, 5).astype(np.float32)
    got, _ = conv_bn_pool._check("Pooling", [x], dict(
        kernel=(2, 2), stride=(3, 3), pad=(1, 1), pool_type="lp",
        p_value=p_value, global_pool=True), [0])
    assert got[0].shape == (2, 4, 1, 1)
    want = (np.abs(x.astype(np.float64)) ** p_value).sum(axis=(2, 3),
                                                         keepdims=True)
    np.testing.assert_allclose(got[0], want ** (1.0 / p_value), rtol=1e-5)


def test_lp_default_p_value_is_2():
    rng = np.random.RandomState(0)
    x = rng.rand(1, 2, 4, 4).astype(np.float32)
    got, want = conv_bn_pool._check("Pooling", [x], dict(
        kernel=(2, 2), stride=(2, 2), pool_type="lp"), [0])
    np.testing.assert_allclose(
        got[0].reshape(-1)[:4], [1.1872, 1.2833, 1.5017, 0.9588], atol=1e-4)
