"""Seeded initializers of the PyTorch package against the JAX package.

Both packages draw an initializer's weights on the host from the numpy
generator ``random.host_rng()`` (after ``random.seed(n)`` a
``np.random.default_rng(n)``), with the same calls in the same order, and
write them into the array once.  So after one ``seed`` in each package,
each initializer gives the same fp32 arrays, bit for bit, on the CPU.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

DENSE, CONV = (5, 7), (4, 3, 3, 3)

INITS = [  # (name, kwargs), one instance per package
    ("Uniform", {}), ("Uniform", {"scale": 0.5}),
    ("Normal", {}), ("Normal", {"sigma": 0.3}),
] + [("Xavier", {"rnd_type": r, "factor_type": f})
     for r in ("uniform", "gaussian") for f in ("avg", "in", "out")] + [
    ("Xavier", {"rnd_type": "gaussian", "factor_type": "in",
                "magnitude": 2}),
]


def _draw(pkg, name, kwargs, shape, seed):
    """``pkg``'s ``name(**kwargs)`` on a fresh fp32 CPU array of ``shape``
    after ``pkg.random.seed(seed)``, twice in a row (the second draw
    continues the stream); numpy arrays."""
    pkg.random.seed(seed)
    init = getattr(pkg.initializer, name)(**kwargs)
    out = []
    for _ in range(2):
        arr = pkg.nd.zeros(shape, ctx=pkg.cpu(), dtype="float32")
        init(pkg.initializer.InitDesc("layer_weight"), arr)
        out.append(arr.asnumpy())
    return out


@pytest.mark.parametrize("shape", [DENSE, CONV], ids=["dense", "conv"])
@pytest.mark.parametrize("name,kwargs", INITS,
                         ids=["%s-%s" % (n, "-".join(map(str, k.values())))
                              for n, k in INITS])
def test_seeded_initializer_matches_jax(name, kwargs, shape):
    got = _draw(mt, name, kwargs, shape, seed=3)
    want = _draw(mx, name, kwargs, shape, seed=3)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == shape
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[1])


def test_seed_changes_the_draw():
    a = _draw(mt, "Xavier", {}, DENSE, seed=0)[0]
    b = _draw(mt, "Xavier", {}, DENSE, seed=1)[0]
    assert not np.array_equal(a, b)


def test_dense_xavier_row():
    """A Gluon ``Dense(3, in_units=4)`` under ``Xavier()`` after
    ``random.seed(0)``: the weights the JAX package draws, in both."""
    want_row0 = [0.2536, -0.4263, -0.8500, -0.8952]
    weights = []
    for pkg in (mx, mt):
        pkg.random.seed(0)
        layer = pkg.gluon.nn.Dense(3, in_units=4)
        layer.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
        weights.append(layer.weight.data().asnumpy())
    np.testing.assert_array_equal(weights[1], weights[0])
    np.testing.assert_allclose(weights[1][0], want_row0, rtol=0, atol=5e-5)
