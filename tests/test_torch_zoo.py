"""The vision zoo of the PyTorch package against the JAX package's on the
CPU.

- ``get_model`` builds every name of the JAX package's table, with the
  same parameter names (the construction order is the same), and
  ``pretrained=True`` raises in every constructor.
- Every family's forward, in predict mode (Dropout the identity), at the
  smallest input its layers take, classes 10, batch 1, from the JAX
  package's initialization carried over by a ``.params`` file: AlexNet at
  63 x 63, VGG-11 (and VGG-11 with BatchNorm) at 32, Inception-v3 at
  299, SqueezeNet 1.0 and 1.1 at 64, MobileNet 0.25 at 32, and DenseNet
  (the family's code at a cut depth: 16 stem channels, growth 8, two
  layers a stage) at 224, which its 7 x 7 closing pool needs.
  Tolerance: fp32 forwards through 10-100 layers sum in other orders, so
  the logits agree to rtol 1e-4 and atol 1e-5.
"""
import os

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import vision as ref_vision

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon.model_zoo import vision

FWD_TOL = dict(rtol=1e-4, atol=1e-5)

REF_TABLE = sorted([
    "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
    "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
    "resnet101_v2", "resnet152_v2", "vgg11", "vgg13", "vgg16", "vgg19",
    "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "alexnet",
    "densenet121", "densenet161", "densenet169", "densenet201",
    "squeezenet1.0", "squeezenet1.1", "inceptionv3", "mobilenet1.0",
    "mobilenet0.75", "mobilenet0.5", "mobilenet0.25"])


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


def test_the_table_is_the_jax_packages():
    assert sorted(vision._MODELS) == REF_TABLE
    with pytest.raises(mt.MXNetError):
        vision.get_model("vgg17")
    with pytest.raises(ValueError):
        ref_vision.get_model("vgg17")


@pytest.mark.parametrize("name", REF_TABLE)
def test_get_model_builds_every_name(name):
    """The same parameter names as the JAX package's model, and
    ``pretrained=True`` raises."""
    names = []
    for pkg, zoo in ((mx, ref_vision), (mt, vision)):
        with pkg.name.NameManager():
            net = zoo.get_model(name, classes=7)
        names.append(sorted(net.collect_params().keys()))
    assert names[0] == names[1]
    with pytest.raises(mt.MXNetError):
        vision.get_model(name, pretrained=True)


def _ref_params(make, x, path):
    """Initialize the JAX package's model on ``x`` and write its
    ``.params``; returns its forward."""
    with mx.cpu():
        mx.random.seed(0)
        net = make(mx)
        net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
        out = net(mx.nd.array(x)).asnumpy()
        net.save_params(path)
    return out


def zoo_forward(make, x, tmp_path, hybrid=True):
    """(the JAX package's logits, this package's) from one init."""
    f = os.path.join(str(tmp_path), "zoo.params")
    want = _ref_params(make, x, f)
    with mt.cpu():
        net = make(mt)
        net.load_params(f, ctx=mt.cpu())
        if hybrid:
            net.hybridize()
        got = net(mt.nd.array(x)).asnumpy()
    return want, got


def _zoo(name, **kw):
    return lambda pkg: (ref_vision if pkg is mx else vision).get_model(
        name, classes=10, **kw)


def _densenet_cut(pkg):
    zoo = ref_vision if pkg is mx else vision
    return zoo.densenet.DenseNet(16, 8, [2, 2, 2, 2], classes=10)


FAMILIES = {
    "alexnet": (_zoo("alexnet"), 63),
    "vgg11": (_zoo("vgg11"), 32),
    "vgg11_bn": (_zoo("vgg11_bn"), 32),
    "inceptionv3": (_zoo("inceptionv3"), 299),
    "squeezenet1.0": (_zoo("squeezenet1.0"), 64),
    "squeezenet1.1": (_zoo("squeezenet1.1"), 64),
    "mobilenet0.25": (_zoo("mobilenet0.25"), 32),
    "densenet-cut": (_densenet_cut, 224),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_forward_against_jax(name, tmp_path):
    make, size = FAMILIES[name]
    x = np.random.RandomState(1).rand(1, 3, size, size).astype(np.float32)
    want, got = zoo_forward(make, x, tmp_path)
    assert got.shape == (1, 10)
    np.testing.assert_allclose(got, want, **FWD_TOL)


def test_densenet121_at_full_depth():
    """DenseNet-121 itself: its forward at 224 gives finite logits of the
    right shape, plain and hybridized alike (the cut-depth model above is
    held against the JAX package)."""
    x = np.random.RandomState(2).rand(1, 3, 224, 224).astype(np.float32)
    with mt.cpu():
        mt.random.seed(0)
        net = vision.get_model("densenet121", classes=10)
        net.initialize(mt.initializer.Xavier())
        plain = net(mt.nd.array(x)).asnumpy()
        net.hybridize()
        hybrid = net(mt.nd.array(x)).asnumpy()
    assert plain.shape == (1, 10) and np.isfinite(plain).all()
    np.testing.assert_allclose(hybrid, plain, rtol=1e-5, atol=1e-6)
