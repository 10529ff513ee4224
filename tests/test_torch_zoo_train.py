"""One SGD training step of zoo models against the JAX package on the CPU,
with every Dropout rate set to 0 (the two packages' generators differ),
in fp64 from one initialization carried over by a ``.params`` file, batch
2: AlexNet (63 x 63) and SqueezeNet 1.1 (64 x 64) through
``hybridize()``, ``SoftmaxCrossEntropyLoss`` and ``Trainer("sgd")`` (lr
0.1, momentum 0.9, wd 1e-4), and MobileNet 0.25 (64 x 64, batch 4)
through ``Module``, as
``examples/train_inception_v3.py`` binds Inception-v3 (``SoftmaxOutput``,
the captured step's path).  Held: the logits and losses, and every
parameter and moving statistic after the step, to rtol 1e-7 and atol
1e-9 (fp64 sums in other orders; the Module step's parameters to atol
1e-6, see its test).  Then Dropout at 0.5 is live: the step
stays finite and its masks differ from call to call.
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
from mxnet_tpu_torch.test_utils import set_dropout

TOL = dict(rtol=1e-7, atol=1e-9)
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    """fp64 needs the JAX package's x64 switch, which another test may
    have turned off in this worker.  Two torch threads: the suite runs
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


def _model(pkg, name):
    zoo = ref_vision if pkg is mx else vision
    with pkg.name.NameManager():
        return zoo.get_model(name, classes=10)


def _init_file(name, x, path):
    with mx.cpu():
        mx.random.seed(0)
        net = _model(mx, name)
        net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
        net(mx.nd.array(x))
        net.save_params(path)


def _batch(size, n=2, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3, size, size).astype(np.float64),
            rng.randint(0, 10, n).astype(np.float64))


def gluon_step(pkg, name, f, x, y, rate=0.0):
    with pkg.cpu():
        net = _model(pkg, name)
        net.load_params(f, ctx=pkg.cpu())
        net.cast("float64")
        set_dropout(net, rate, pkg.gluon.nn)
        net.hybridize()
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        xs = pkg.nd.array(x, dtype="float64")
        ys = pkg.nd.array(y, dtype="float64")
        with pkg.autograd.record():
            out = net(xs)
            loss = loss_fn(out, ys)
        loss.backward()
        trainer.step(x.shape[0])
        params = {n: p.data().asnumpy()
                  for n, p in net.collect_params().items()}
        return out.asnumpy(), loss.asnumpy(), params, net


@pytest.mark.parametrize("name,size", [("alexnet", 63),
                                       ("squeezenet1.1", 64)])
def test_gluon_sgd_step_against_jax(name, size, tmp_path):
    x, y = _batch(size)
    f = os.path.join(str(tmp_path), "init.params")
    _init_file(name, x.astype(np.float32), f)
    want = gluon_step(mx, name, f, x, y)
    got = gluon_step(mt, name, f, x, y)
    np.testing.assert_allclose(got[0], want[0], err_msg="logits", **TOL)
    np.testing.assert_allclose(got[1], want[1], err_msg="loss", **TOL)
    assert got[2].keys() == want[2].keys()
    for n in got[2]:
        np.testing.assert_allclose(got[2][n], want[2][n], err_msg=n, **TOL)


def test_gluon_step_with_live_dropout(tmp_path):
    """AlexNet with its two Dropout(0.5) live: finite loss, and two
    recorded forwards of one batch draw different masks."""
    x, y = _batch(63)
    f = os.path.join(str(tmp_path), "init.params")
    _init_file("alexnet", x.astype(np.float32), f)
    mt.random.seed(0)
    out, loss, _, net = gluon_step(mt, "alexnet", f, x, y, rate=0.5)
    assert np.isfinite(loss).all()
    with mt.cpu():
        with mt.autograd.record():
            a = net(mt.nd.array(x, dtype="float64")).asnumpy()
        with mt.autograd.record():
            b = net(mt.nd.array(x, dtype="float64")).asnumpy()
        c = net(mt.nd.array(x, dtype="float64")).asnumpy()
        d = net(mt.nd.array(x, dtype="float64")).asnumpy()
    assert not np.allclose(a, b)
    np.testing.assert_array_equal(c, d)


def module_step(pkg, name, f, x, y):
    """``examples/train_inception_v3.py``'s set-up at a small size: the
    zoo model traced on ``sym.Variable``, ``SoftmaxOutput``, ``Module`` on
    the CPU, parameters from ``f``, SGD; one ``_fit_step``."""
    with pkg.cpu():
        net = _model(pkg, name)
        set_dropout(net, 0.0, pkg.gluon.nn)
        net.cast("float64")
        out = pkg.sym.SoftmaxOutput(net(pkg.sym.Variable("data")),
                                    pkg.sym.Variable("softmax_label"),
                                    name="softmax")
        mod = pkg.mod.Module(out, context=pkg.cpu())
        mod.bind(data_shapes=[pkg.io.DataDesc("data", x.shape,
                                              dtype="float64")],
                 label_shapes=[pkg.io.DataDesc("softmax_label", y.shape,
                                               dtype="float64")])
        loaded = pkg.nd.load(f)
        arg = {k: v.astype("float64") for k, v in loaded.items()}
        names = set(mod._exec_group.execs[0].arg_dict)
        mod.init_params(arg_params={k: v for k, v in arg.items()
                                    if k in names},
                        aux_params={k: v for k, v in arg.items()
                                    if k not in names})
        mod.init_optimizer(optimizer="sgd", optimizer_params=tuple(
            SGD.items()))
        batch = pkg.io.DataBatch([pkg.nd.array(x, dtype="float64")],
                                 [pkg.nd.array(y, dtype="float64")])
        mod._fit_step(batch)
        prob = mod.get_outputs()[0].asnumpy()
        arg_p, aux_p = mod.get_params()
        return prob, {n: v.asnumpy() for n, v in
                      list(arg_p.items()) + list(aux_p.items())}


def test_module_sgd_step_against_jax(tmp_path):
    """MobileNet 0.25 through ``Module`` (the prefixed names the zoo model
    gives a Symbol are those of its ``.params`` file), at 64 x 64 and batch
    4.  The parameters after the step are held as
    ``tests/test_torch_module.py`` holds its fp64 Module steps, to atol
    1e-6 (``FP64_ATOL``): the two captured steps' updates differ there by
    up to 6e-9 absolute on weights of size 0.01."""
    x, y = _batch(64, n=4)
    f = os.path.join(str(tmp_path), "init.params")
    with mx.cpu():
        mx.random.seed(0)
        net = _model(mx, "mobilenet0.25")
        net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
        net(mx.nd.array(x.astype(np.float32)))
        net.collect_params().save(f)
    want = module_step(mx, "mobilenet0.25", f, x, y)
    got = module_step(mt, "mobilenet0.25", f, x, y)
    np.testing.assert_allclose(got[0], want[0], err_msg="softmax", **TOL)
    assert got[1].keys() == want[1].keys()
    for n in got[1]:
        np.testing.assert_allclose(got[1][n], want[1][n], err_msg=n,
                                   rtol=0, atol=1e-6)
