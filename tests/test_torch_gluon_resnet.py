"""The Gluon ResNets of the PyTorch package against the JAX package's on
the CPU: parameter names and shapes, the lowered Symbol's arguments, aux
states and inferred shapes, the imperative and the bound forward from
the JAX package's parameters, and Gluon's own rules (deferred shapes,
name scopes, ``cast``, ``hybridize``, refusals).

Both packages build each net inside a fresh ``NameManager``, so that
the names do not depend on what earlier tests built.  Forward outputs
are fp32 softmax probabilities or logits of the same arithmetic summed
in other orders: atol 1e-4 (the bar of the issue), measured near 1e-6.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon import nn

ATOL = 1e-4
ALL = ["resnet%d_v%d" % (d, v) for v in (1, 2) for d in (18, 34, 50, 101,
                                                        152)]


def build(pkg, name, **kw):
    with pkg.name.NameManager():
        return pkg.gluon.model_zoo.vision.get_model(name, **kw)


@pytest.mark.parametrize("name", ALL)
def test_zoo_parameter_names_and_shapes(name):
    """Every depth, V1 and V2: the same parameters in the same order, with
    the same declared shapes (0 where the first input decides)."""
    want = [(k, p.shape) for k, p in build(mx, name).collect_params().items()]
    got = [(k, p.shape) for k, p in build(mt, name).collect_params().items()]
    assert got == want


@pytest.mark.parametrize("name,kw", [("resnet18_v1", {}),
                                     ("resnet50_v1", {}),
                                     ("resnet18_v2", {}),
                                     ("resnet18_v1", dict(thumbnail=True,
                                                          classes=10))])
def test_symbol_arguments_aux_and_shapes(name, kw):
    """The Symbol path: list_arguments, list_auxiliary_states and the
    shapes ``simple_bind`` would allocate."""
    size = 32 if kw.get("thumbnail") else 224
    res = []
    for pkg in (mx, mt):
        s = build(pkg, name, **kw)(pkg.sym.var("data"))
        res.append((s.list_arguments(), s.list_auxiliary_states(),
                    s.infer_shape(data=(1, 3, size, size))))
    assert res[1] == res[0]
    if name == "resnet50_v1":
        args, aux, _ = res[1]
        # 53 conv weights, 32 bottleneck 1x1 biases, 53 x (gamma, beta),
        # the dense weight and bias; 53 x (running mean, running var)
        assert len(args) == 1 + 193 and len(aux) == 106


def _jax_params(name, kw, shape, dtype="float32"):
    """A JAX Module over the zoo net + SoftmaxOutput, Xavier-initialized;
    returns (module, {arg: numpy}, {aux: numpy})."""
    s = mx.sym.SoftmaxOutput(build(mx, name, **kw)(mx.sym.var("data")),
                             mx.sym.var("softmax_label"), name="softmax")
    mod = mx.mod.Module(s, context=mx.cpu())
    mod.bind(data_shapes=[mx.io.DataDesc("data", shape, dtype=dtype)],
             label_shapes=[mx.io.DataDesc("softmax_label", shape[:1])])
    mx.random.seed(3)
    mod.init_params(mx.init.Xavier())
    arg, aux = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in arg.items()}, \
        {k: v.asnumpy() for k, v in aux.items()}


@pytest.fixture(scope="module")
def thumbnail18():
    """resnet18_v1(thumbnail=True, classes=10) in the JAX package at
    batch 2 x 3 x 32 x 32, with its parameters and one seeded batch."""
    shape = (2, 3, 32, 32)
    mod, arg, aux = _jax_params("resnet18_v1", dict(thumbnail=True,
                                                    classes=10), shape)
    rng = np.random.RandomState(11)
    x = rng.rand(*shape).astype(np.float32)
    y = rng.randint(0, 10, (2,)).astype(np.float32)
    return dict(mod=mod, arg=arg, aux=aux, x=x, y=y, shape=shape)


def _jax_forward(t, is_train):
    """The JAX Module's output from the fixture's parameters (a training
    forward moves its BatchNorm statistics, so they are set each time)."""
    t["mod"].set_params({k: mx.nd.array(v) for k, v in t["arg"].items()},
                        {k: mx.nd.array(v) for k, v in t["aux"].items()})
    t["mod"].forward(mx.io.DataBatch([mx.nd.array(t["x"])],
                                     [mx.nd.array(t["y"])]),
                     is_train=is_train)
    return t["mod"].get_outputs()[0].asnumpy()


def test_bound_forward_matches_from_carried_params(thumbnail18):
    """The lowered net bound by ``Module`` from ``params_from_jax``:
    forward in predict and in train mode."""
    t = thumbnail18
    s = mt.sym.SoftmaxOutput(
        build(mt, "resnet18_v1", thumbnail=True, classes=10)(
            mt.sym.var("data")), mt.sym.var("softmax_label"), name="softmax")
    mod = mt.mod.Module(s, context=mt.cpu())
    mod.bind(data_shapes=[("data", t["shape"])],
             label_shapes=[("softmax_label", t["shape"][:1])])
    arg, aux = mt.mod.params_from_jax(t["arg"], t["aux"], s, ctx=mt.cpu(),
                                      data_shapes=[("data", t["shape"])])
    mod.set_params(arg, aux)
    for is_train in (False, True):
        want = _jax_forward(t, is_train)
        mod.forward(mt.io.DataBatch([mt.nd.array(t["x"], ctx=mt.cpu())],
                                    [mt.nd.array(t["y"], ctx=mt.cpu())]),
                    is_train=is_train)
        got = mod.get_outputs()[0].asnumpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg="is_train=%s" % is_train)


def test_imperative_forward_matches(thumbnail18):
    """The Gluon block on NDArrays (deferred shapes from the first input,
    then the JAX parameters set by name) against the JAX Module's
    predict-mode output: the same logits under the softmax."""
    t = thumbnail18
    net = build(mt, "resnet18_v1", thumbnail=True, classes=10)
    net.initialize(mt.init.Xavier(), ctx=mt.cpu())
    x = mt.nd.array(t["x"], ctx=mt.cpu())
    net(x)  # finishes the deferred initialization
    for name, p in net.collect_params().items():
        p.set_data(t["arg"].get(name, t["aux"].get(name)))
    logits = net(x).asnumpy()
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob /= prob.sum(1, keepdims=True)
    np.testing.assert_allclose(prob, _jax_forward(t, False), atol=ATOL,
                               rtol=0)


def test_params_from_jax_checks_names_shapes_and_dtypes(thumbnail18):
    t = thumbnail18
    s = build(mt, "resnet18_v1", thumbnail=True, classes=10)(
        mt.sym.var("data"))
    data = [("data", t["shape"])]
    bad_shape = dict(t["arg"])
    k = "resnetv10_dense0_weight"
    bad_shape[k] = np.zeros((10, 3), np.float32)
    bad_dtype = dict(t["arg"], **{k: t["arg"][k].astype(np.float64)})
    extra = dict(t["arg"], nonsense_weight=np.zeros(3, np.float32))
    missing_aux = dict(t["aux"])
    missing_aux.popitem()
    for arg, aux in ((bad_shape, t["aux"]), (bad_dtype, t["aux"]),
                     (extra, t["aux"]), (t["arg"], missing_aux)):
        with pytest.raises(MXNetError):
            mt.mod.params_from_jax(arg, aux, s, ctx=mt.cpu(),
                                   data_shapes=data)
    arg, aux = mt.mod.params_from_jax(t["arg"], t["aux"], s, ctx=mt.cpu(),
                                      data_shapes=data)
    assert set(arg) == set(t["arg"]) and set(aux) == set(t["aux"])
    assert arg[k].context == mt.cpu() and arg[k].shape == (10, 512)


def test_deferred_shapes_and_gluon_initializers():
    """``in_channels=0`` layers take their shapes from the first input;
    gamma/running_var start at one, beta/bias/running_mean at zero."""
    with mt.name.NameManager():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                    nn.Activation("relu"), nn.MaxPool2D(2),
                    nn.GlobalAvgPool2D(), nn.Dense(3))
    params = net.collect_params()
    assert params["hybridsequential0_conv2d0_weight"].shape == (4, 0, 3, 3)
    net.initialize(mt.init.Xavier(), ctx=mt.cpu())
    out = net(mt.nd.array(np.ones((2, 5, 8, 8), np.float32), ctx=mt.cpu()))
    assert out.shape == (2, 3)
    assert params["hybridsequential0_conv2d0_weight"].shape == (4, 5, 3, 3)
    assert params["hybridsequential0_dense0_weight"].shape == (3, 4)
    for suffix, value in (("gamma", 1), ("running_var", 1), ("beta", 0),
                          ("running_mean", 0), ("conv2d0_bias", 0)):
        p = next(v for k, v in params.items() if k.endswith(suffix))
        assert (p.data().asnumpy() == value).all(), suffix


def test_cast_hybridize_and_autograd():
    """``cast`` changes every parameter's dtype (bf16 included), the
    imperative forward runs in it, ``hybridize`` keeps the imperative
    path, and ``autograd`` reaches the parameters' gradients."""
    net = build(mt, "resnet18_v1", thumbnail=True, classes=4)
    net.initialize(mt.init.Xavier(), ctx=mt.cpu())
    x = mt.nd.array(np.random.RandomState(0).rand(2, 3, 32, 32), ctx=mt.cpu())
    net(x)
    net.hybridize()
    with mt.autograd.record():
        y = net(x)
    y.backward()
    w = net.collect_params()["resnetv10_dense0_weight"]
    assert np.abs(w.grad().asnumpy()).sum() > 0
    net.cast("bfloat16")
    assert all(p.data()._data.dtype == mt.base.torch_dtype("bfloat16")
               for p in net.collect_params().values())
    out = net(x.astype("bfloat16"))
    assert out.dtype == mt.base.torch_dtype("bfloat16") and out.shape == (2, 4)
    s = net(mt.sym.var("data"))
    assert s.attr_dict()["resnetv10_dense0_weight"]["__dtype__"] == "bfloat16"


def test_names_follow_the_construction_sequence():
    """Without a fresh scope, names count up per package as in the JAX
    package: the same construction sequence gives the same names."""
    names = []
    for pkg in (mx, mt):
        with pkg.name.NameManager():
            a = pkg.gluon.nn.Dense(3)
            b = pkg.gluon.model_zoo.vision.resnet18_v1()
            c = pkg.gluon.nn.Dense(2, prefix="head_")
        names.append([a.prefix, b.prefix, c.prefix,
                      list(b.collect_params())[:3]])
    assert names[0] == names[1]


def test_default_context_and_refusals():
    """``initialize()`` without a context uses the current one, gpu(0): with
    no card that raises (no move to the CPU).  A zoo name that neither
    package has and pretrained weights raise."""
    net = build(mt, "resnet18_v1", thumbnail=True, classes=2)
    if torch.cuda.is_available():
        net.initialize()
        net(mt.nd.array(np.zeros((1, 3, 32, 32), np.float32)))
        assert all(p.data().context == mt.gpu(0)
                   for p in net.collect_params().values())
    else:
        with pytest.raises(MXNetError):
            net.initialize()
    with pytest.raises(MXNetError):
        mt.gluon.model_zoo.vision.get_model("resnet200_v3")
    with pytest.raises(MXNetError):
        mt.gluon.model_zoo.vision.resnet50_v1(pretrained=True)
