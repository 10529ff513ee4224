"""The initializers the PyTorch package took with the API surface
(``Orthogonal``, ``MSRAPrelu``, ``Bilinear``, ``Load``, ``Mixed``) and
the registry, against the JAX package.

Mirrors ``tests/test_initializer.py:41-130`` case for case, in both
packages.  Every seeded draw comes from the numpy ``random.host_rng()``
with the JAX package's calls (``Orthogonal``'s SVD included), so each
array is held equal bit for bit.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

PKGS = {"jax": mx, "torch": mt}


def _init_arr(pkg, init, name="weight", shape=(50, 100), seed=None):
    if seed is not None:
        pkg.random.seed(seed)
    arr = pkg.nd.zeros(shape, ctx=pkg.cpu())
    init(pkg.init.InitDesc(name), arr)
    return arr.asnumpy()


def _both(make, **kw):
    """{key: the array ``make(pkg)`` initializes}, the two held equal
    bit for bit."""
    got = {key: _init_arr(pkg, make(pkg), **kw) for key, pkg in PKGS.items()}
    np.testing.assert_array_equal(got["torch"], got["jax"])
    return got["torch"]


SEEDED = {
    "orthogonal_uniform": lambda p: p.init.Orthogonal(),
    "orthogonal_normal": lambda p: p.init.Orthogonal(scale=0.5,
                                                      rand_type="normal"),
    "msra_prelu": lambda p: p.init.MSRAPrelu(),
    "msra_prelu_in": lambda p: p.init.MSRAPrelu(factor_type="in", slope=0.1),
}


@pytest.mark.parametrize("shape", [(32, 32), (16, 48), (48, 16),
                                   (8, 3, 3, 3)], ids=str)
@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_draw_matches_reference(name, shape):
    _both(SEEDED[name], shape=shape, seed=5)


def test_orthogonal_is_orthogonal():
    out = _both(lambda p: p.init.Orthogonal(), shape=(32, 32), seed=0)
    eye = out @ out.T
    assert np.allclose(eye, np.eye(32) * eye[0, 0], atol=1e-3)


def test_name_pattern_dispatch():
    for pkg in PKGS.values():
        init = pkg.init.Xavier()
        for name, start, want in (("fc1_bias", 1, 0), ("bn0_gamma", 0, 1),
                                  ("bn0_running_mean", 1, 0),
                                  ("bn0_running_var", 0, 1)):
            arr = (pkg.nd.ones if start else pkg.nd.zeros)((10,),
                                                          ctx=pkg.cpu())
            init(pkg.init.InitDesc(name), arr)
            assert (arr.asnumpy() == want).all()


def test_msra_prelu():
    out = _both(lambda p: p.init.MSRAPrelu(), shape=(64, 64), seed=2)
    assert out.std() > 0
    assert mt.init.MSRAPrelu(slope=0.5).dumps() \
        == mx.init.MSRAPrelu(slope=0.5).dumps()


@pytest.mark.parametrize("shape", [(1, 1, 4, 4), (3, 3, 16, 16),
                                   (2, 1, 5, 7)], ids=str)
def test_bilinear_upsampling_kernel(shape):
    out = _both(lambda p: p.init.Bilinear(), name="upsample_weight",
                shape=shape)
    k = out[0, 0]
    assert k.max() <= 1.0 and k[1, 1] > k[0, 0]


def test_mixed_initializer():
    for pkg in PKGS.values():
        init = pkg.init.Mixed(["bias", ".*"], [pkg.init.Zero(),
                                               pkg.init.One()])
        w = pkg.nd.zeros((4,), ctx=pkg.cpu())
        init(pkg.init.InitDesc("fc_weight"), w)
        assert (w.asnumpy() == 1).all()
        b = pkg.nd.ones((4,), ctx=pkg.cpu())
        init(pkg.init.InitDesc("fc_bias"), b)
        assert (b.asnumpy() == 0).all()
        with pytest.raises(ValueError):
            pkg.init.Mixed(["a"], [])
        with pytest.raises(ValueError):
            pkg.init.Mixed(["fc_.*"], [pkg.init.One()])(
                "conv_weight", pkg.nd.zeros((1,), ctx=pkg.cpu()))


def test_mixed_bilinear_xavier_seeded():
    """``examples/fcn_xs.py``'s ``Mixed([Bilinear, Xavier])`` over a
    sequence of names, one seeded stream."""
    names = [("score2_weight", (3, 3, 4, 4)), ("conv_1_weight", (16, 3, 3, 3)),
             ("bigscore_weight", (3, 3, 16, 16)), ("fc_weight", (5, 7))]
    got = {}
    for key, pkg in PKGS.items():
        pkg.random.seed(13)
        init = pkg.initializer.Mixed(
            ["(score2|score4|bigscore)_weight", ".*"],
            [pkg.initializer.Bilinear(), pkg.initializer.Xavier()])
        out = []
        for name, shape in names:
            arr = pkg.nd.zeros(shape, ctx=pkg.cpu())
            init(name, arr)
            out.append(arr.asnumpy())
        got[key] = out
    for a, b in zip(got["torch"], got["jax"]):
        np.testing.assert_array_equal(a, b)


def test_load_initializer(tmp_path):
    path = str(tmp_path / "p.params")
    rng = np.random.RandomState(3)
    w, b = rng.randn(4, 3).astype(np.float32), rng.randn(4).astype(np.float32)
    mt.nd.save(path, {"arg:fc_weight": mt.nd.array(w, ctx=mt.cpu()),
                      "aux:fc_bias": mt.nd.array(b, ctx=mt.cpu())})
    got = {}
    for key, pkg in PKGS.items():
        pkg.random.seed(1)
        load = pkg.init.Load(path, default_init=pkg.init.Uniform(0.5))
        out = []
        for name, shape in (("fc_weight", (4, 3)), ("fc_bias", (4,)),
                            ("other_weight", (2, 2))):
            arr = pkg.nd.zeros(shape, ctx=pkg.cpu())
            load(name, arr)
            out.append(arr.asnumpy())
        with pytest.raises(pkg.MXNetError):
            load("fc_weight", pkg.nd.zeros((3, 4), ctx=pkg.cpu()))
        with pytest.raises(pkg.MXNetError):
            pkg.init.Load(path)("missing", pkg.nd.zeros((1,), ctx=pkg.cpu()))
        got[key] = out
    np.testing.assert_array_equal(got["torch"][0], w)
    np.testing.assert_array_equal(got["torch"][1], b)
    for a, c in zip(got["torch"], got["jax"]):
        np.testing.assert_array_equal(a, c)


def test_load_from_a_dict_of_arrays():
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    for pkg in PKGS.values():
        load = pkg.init.Load({"arg:w": pkg.nd.array(w, ctx=pkg.cpu())})
        arr = pkg.nd.zeros((2, 3), ctx=pkg.cpu())
        load("w", arr)
        np.testing.assert_array_equal(arr.asnumpy(), w)


def test_registry_and_namespace():
    for name in ("orthogonal", "msraprelu", "bilinear", "load", "mixed",
                 "xavier", "zeros", "ones"):
        assert mt.initializer._REG.get(name).__name__ \
            == mx.initializer._REG.get(name).__name__
    assert mt.initializer._REG.names() == mx.initializer._REG.names()
    assert isinstance(mt.initializer.create("orthogonal"),
                      mt.init.Orthogonal)
    assert isinstance(mt.initializer.create(mt.init.MSRAPrelu().dumps()),
                      mt.initializer.MSRAPrelu)
    assert mt.initializer.init.Mixed is mt.initializer.Mixed
    reg = mt.initializer.Registry("thing")
    reg.register(dict, "d", aliases=("Dee",))
    assert reg.get("DEE") is dict and reg.find("x") is None
    with pytest.raises(mt.MXNetError):
        reg.get("x")


def test_variable_level_init_override_honored():
    for pkg in PKGS.values():
        net = pkg.sym.FullyConnected(
            pkg.sym.Variable("data"),
            weight=pkg.sym.Variable("fcw",
                                    init=pkg.initializer.Orthogonal()),
            num_hidden=4, name="fc")
        net = pkg.sym.SoftmaxOutput(net, pkg.sym.Variable("softmax_label"),
                                    name="softmax")
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.bind(data_shapes=[("data", (2, 3))],
                 label_shapes=[("softmax_label", (2,))])
        pkg.random.seed(4)
        mod.init_params(initializer=pkg.initializer.Zero())
        w = mod._exec_group.execs[0].arg_dict["fcw"].asnumpy()
        if pkg is mx:
            want = w
        else:
            np.testing.assert_array_equal(w, want)
    assert np.abs(want).max() > 0


def test_string_form_init_attr_accepted():
    for pkg in PKGS.values():
        net = pkg.sym.FullyConnected(
            pkg.sym.Variable("data"),
            weight=pkg.sym.Variable("fcw", init="ones"),
            num_hidden=4, name="fc")
        net = pkg.sym.SoftmaxOutput(net, pkg.sym.Variable("softmax_label"),
                                    name="softmax")
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.bind(data_shapes=[("data", (2, 3))],
                 label_shapes=[("softmax_label", (2,))])
        mod.init_params(initializer=pkg.initializer.Uniform(0.1))
        w = mod._exec_group.execs[0].arg_dict["fcw"].asnumpy()
        assert np.all(w == 1.0)
