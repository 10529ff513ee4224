"""The Gluon layers of this slice against the JAX package's on the CPU:
``Dropout``, ``LeakyReLU``, ``Embedding``, ``InstanceNorm``,
``LayerNorm``, ``Lambda``, ``HybridLambda``, ``Conv1D``/``Conv3D``, the
three transposed convolutions, the 1-D and 3-D pools and the global
pools.

Each layer is built in both packages; the JAX package's is initialized
and its ``.params`` file loaded into this package's (``load_params``), so
both hold the same weights; the forward on one seeded input, plain and
hybridized, and the gradients of the input and of every parameter under a
seeded head gradient are compared (fp32: rtol 1e-5, atol 1e-5, sums in
other orders); then this package's ``.params`` file is loaded by a fresh
JAX-package layer and must give back the same values bit for bit.
"""
import os

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    """The JAX package turns x64 on at import; another test may have
    turned it off in this worker.  Two torch threads: the suite runs
    several workers on one machine."""
    prev = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_enable_x64", prev[0])
    torch.set_num_threads(prev[1])


@pytest.fixture(autouse=True)
def own_names():
    """Symbols and blocks made here take their names from name managers
    of their own: the processes' global counters, which a later test may
    read (auto-named nodes of a traced net), stay as they were."""
    with mx.name.NameManager(), mt.name.NameManager():
        yield


def _run(pkg, net, x, head, hybrid, train):
    """Forward (and, with ``head``, backward) of ``net`` on ``x``: the
    output, the input's gradient and {name: gradient} of the parameters."""
    if hybrid:
        net.hybridize()
    a = pkg.nd.array(x)
    a.attach_grad()
    with pkg.autograd.record(train_mode=train):
        out = net(a)
    grads = {}
    if head is not None:
        out.backward(pkg.nd.array(head))
        grads = {n.split("_", 1)[1]: p.grad().asnumpy()
                 for n, p in net.collect_params().items()
                 if p.grad_req != "null"}
    return out.asnumpy(), (a.grad.asnumpy() if head is not None else None), \
        grads


def _load(net, f, ctx):
    """``load_params``, or for a layer without parameters ``initialize``
    (an empty ``.params`` file is a list to the JAX package)."""
    if net.collect_params():
        net.load_params(f, ctx=ctx)
    else:
        net.initialize(ctx=ctx)


def check_layer(make, x, tmp_path, grad=True, train=False):
    """``make(pkg)`` builds the layer; see the module docstring."""
    with mx.cpu():
        ref = make(mx)
        ref.initialize(ctx=mx.cpu())
        ref(mx.nd.array(x))
        f = os.path.join(str(tmp_path), "ref.params")
        ref.save_params(f)
    out_shape = ref(mx.nd.array(x)).shape
    head = np.random.RandomState(1).randn(*out_shape).astype(np.float32) \
        if grad else None
    for hybrid in (False, True):
        with mx.cpu():
            theirs = make(mx)
            _load(theirs, f, mx.cpu())
            want = _run(mx, theirs, x, head, hybrid, train)
        with mt.cpu():
            ours = make(mt)
            _load(ours, f, mt.cpu())
            got = _run(mt, ours, x, head, hybrid, train)
        np.testing.assert_allclose(got[0], want[0], err_msg="forward", **TOL)
        if grad:
            np.testing.assert_allclose(got[1], want[1], err_msg="dx", **TOL)
            assert got[2].keys() == want[2].keys()
            for n in got[2]:
                np.testing.assert_allclose(got[2][n], want[2][n],
                                           err_msg="grad " + n, **TOL)
    if not ours.collect_params():
        return
    # this package's file, read by the JAX package
    g = os.path.join(str(tmp_path), "port.params")
    ours.save_params(g)
    with mx.cpu():
        back = make(mx)
        back.load_params(g, ctx=mx.cpu())
    mine = {n.split("_", 1)[1]: p.data().asnumpy()
            for n, p in ours.collect_params().items()}
    theirs = {n.split("_", 1)[1]: p.data().asnumpy()
              for n, p in back.collect_params().items()}
    assert mine.keys() == theirs.keys()
    for n in mine:
        np.testing.assert_array_equal(mine[n], theirs[n])


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


LAYERS = {
    "Dropout": (lambda pkg: pkg.gluon.nn.Dropout(0.5), _x(4, 6)),
    "LeakyReLU": (lambda pkg: pkg.gluon.nn.LeakyReLU(0.2), _x(4, 6)),
    "InstanceNorm": (lambda pkg: pkg.gluon.nn.InstanceNorm(scale=True),
                     _x(2, 3, 4, 5)),
    "InstanceNorm-fixed-gamma": (lambda pkg: pkg.gluon.nn.InstanceNorm(),
                                 _x(2, 3, 4, 5)),
    "LayerNorm": (lambda pkg: pkg.gluon.nn.LayerNorm(), _x(3, 4, 6)),
    "LayerNorm-axis1": (lambda pkg: pkg.gluon.nn.LayerNorm(
        axis=1, in_channels=4), _x(3, 4, 6)),
    "HybridLambda-name": (lambda pkg: pkg.gluon.nn.HybridLambda("tanh"),
                          _x(3, 4)),
    "HybridLambda-fn": (lambda pkg: pkg.gluon.nn.HybridLambda(
        lambda F, x: F.LeakyReLU(x, act_type="elu", slope=0.5)), _x(3, 4)),
    "Conv1D": (lambda pkg: pkg.gluon.nn.Conv1D(5, 3, strides=2, padding=1,
                                               dilation=1), _x(2, 3, 11)),
    "Conv3D": (lambda pkg: pkg.gluon.nn.Conv3D(4, (3, 2, 3), padding=1,
                                               groups=2, activation="relu"),
               _x(1, 2, 5, 4, 5)),
    "Conv1DTranspose": (lambda pkg: pkg.gluon.nn.Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1), _x(2, 3, 6)),
    "Conv2DTranspose": (lambda pkg: pkg.gluon.nn.Conv2DTranspose(
        6, (4, 3), strides=(2, 1), padding=(1, 1), groups=2,
        in_channels=4), _x(1, 4, 5, 5)),
    "Conv3DTranspose": (lambda pkg: pkg.gluon.nn.Conv3DTranspose(
        2, 3, strides=2, use_bias=False), _x(1, 3, 3, 3, 3)),
    "MaxPool1D": (lambda pkg: pkg.gluon.nn.MaxPool1D(3, 2, 1),
                  _x(2, 3, 10)),
    "MaxPool3D": (lambda pkg: pkg.gluon.nn.MaxPool3D(ceil_mode=True),
                  _x(1, 2, 5, 5, 5)),
    "AvgPool1D": (lambda pkg: pkg.gluon.nn.AvgPool1D(3, 2, 1), _x(2, 3, 10)),
    "AvgPool3D": (lambda pkg: pkg.gluon.nn.AvgPool3D((2, 3, 2)),
                  _x(1, 2, 4, 6, 4)),
    "GlobalMaxPool1D": (lambda pkg: pkg.gluon.nn.GlobalMaxPool1D(),
                        _x(2, 3, 7)),
    "GlobalMaxPool2D": (lambda pkg: pkg.gluon.nn.GlobalMaxPool2D(),
                        _x(2, 3, 5, 4)),
    "GlobalMaxPool3D": (lambda pkg: pkg.gluon.nn.GlobalMaxPool3D(),
                        _x(1, 2, 3, 4, 5)),
    "GlobalAvgPool1D": (lambda pkg: pkg.gluon.nn.GlobalAvgPool1D(),
                        _x(2, 3, 7)),
    "GlobalAvgPool3D": (lambda pkg: pkg.gluon.nn.GlobalAvgPool3D(),
                        _x(1, 2, 3, 4, 5)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_against_jax(name, tmp_path):
    make, x = LAYERS[name]
    check_layer(make, x, tmp_path)


def test_embedding_against_jax(tmp_path):
    idx = np.array([[1, 4, 1], [0, 2, 4]], np.float32)
    with mx.cpu():
        ref = mx.gluon.nn.Embedding(5, 3)
        ref.initialize(ctx=mx.cpu())
        f = os.path.join(str(tmp_path), "emb.params")
        ref.save_params(f)
    head = _x(2, 3, 3, seed=2)
    res = []
    for pkg in (mx, mt):
        with pkg.cpu():
            net = pkg.gluon.nn.Embedding(5, 3)
            net.load_params(f, ctx=pkg.cpu())
            net.hybridize()
            with pkg.autograd.record():
                out = net(pkg.nd.array(idx))
            out.backward(pkg.nd.array(head))
            res.append((out.asnumpy(), net.weight.grad().asnumpy()))
    np.testing.assert_allclose(res[1][0], res[0][0], **TOL)
    np.testing.assert_allclose(res[1][1], res[0][1], **TOL)
    # rows 1 and 4 were looked up twice: their gradients add up
    np.testing.assert_allclose(res[1][1][1], head[0, 0] + head[0, 2],
                               rtol=1e-6)


def test_lambda_blocks():
    x = _x(3, 4)
    for pkg in (mx, mt):
        with pkg.cpu():
            a = pkg.gluon.nn.Lambda("tanh")(pkg.nd.array(x)).asnumpy()
            b = pkg.gluon.nn.Lambda(lambda v: v * 2)(pkg.nd.array(x))
            np.testing.assert_allclose(a, np.tanh(x), rtol=1e-6)
            np.testing.assert_allclose(b.asnumpy(), 2 * x)
    with pytest.raises(ValueError):
        mt.gluon.nn.Lambda("no_such_op")
    with pytest.raises(ValueError):
        mt.gluon.nn.HybridLambda("no_such_op")


def test_dropout_layer_trains_and_infers():
    """In training about half the units are dropped and the rest doubled;
    at inference the layer is the identity, plain and hybridized."""
    mt.random.seed(0)
    with mt.cpu():
        for hybrid in (False, True):
            net = mt.gluon.nn.Dropout(0.5)
            net.initialize()
            if hybrid:
                net.hybridize()
            x = mt.nd.ones((100, 100))
            with mt.autograd.record():
                y = net(x).asnumpy()
            assert 0.45 < (y == 0).mean() < 0.55
            assert set(np.unique(y)) == {0.0, 2.0}
            np.testing.assert_array_equal(net(x).asnumpy(), 1.0)


def test_deferred_shapes_of_the_new_layers():
    """Layers with ``in_channels`` 0 take their weight shapes from the
    first input, as the JAX package's do."""
    cases = [(lambda pkg: pkg.gluon.nn.Conv2DTranspose(6, 3, groups=3),
              (1, 9, 4, 4)),
             (lambda pkg: pkg.gluon.nn.LayerNorm(axis=1), (2, 7, 3)),
             (lambda pkg: pkg.gluon.nn.InstanceNorm(), (2, 5, 3, 3)),
             (lambda pkg: pkg.gluon.nn.Conv1D(4, 2), (1, 3, 6))]
    for make, shape in cases:
        shapes = []
        for pkg in (mx, mt):
            with pkg.cpu():
                net = make(pkg)
                net.initialize()
                net(pkg.nd.zeros(shape))
                shapes.append(sorted((n.split("_", 1)[1], p.shape) for n, p in
                                     net.collect_params().items()))
        assert shapes[0] == shapes[1]
