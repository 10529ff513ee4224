"""Training the MNIST MLP (784-128-64-10, batch 64) through the registered
``pl_scale`` in both packages: the same synthetic digits, the same Xavier
parameters (carried across by ``params_from_jax``), SGD with momentum
0.9, learning rate 0.1 and rescale_grad 1/64, on the CPU in fp32.

``chip_smoke.py`` runs the same loop on the card (its ``bind_mlp``,
``train_mlp`` and ``eval_mlp`` are exercised here on the CPU) and holds
the card's test accuracy to ``JAX_CPU_ACCURACY``, which
``test_jax_reference_accuracy`` measures.
"""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx
from mxnet_tpu.test_utils import get_mnist as jax_get_mnist

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 64


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load_chip_smoke()


def _jax_scale(x, alpha=2.0, interpret=False):
    from jax.experimental import pallas as pl

    def body(x_ref, o_ref, *, alpha):
        o_ref[...] = x_ref[...] * alpha
    return pl.pallas_call(functools.partial(body, alpha=float(alpha)),
                          out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                          interpret=bool(interpret))(x)


@pytest.fixture
def kernels():
    cs.register_pl_scale()
    mx.pallas.register("pl_scale", _jax_scale, grad=cs.scale_grad, force=True)
    yield
    mt.rtc.unregister("pl_scale")
    mx.pallas.unregister("pl_scale")


def _data():
    blob = mt.test_utils.get_mnist()
    return (blob["train_data"].reshape(-1, 784), blob["train_label"],
            blob["test_data"].reshape(-1, 784), blob["test_label"])


def _jax_exe():
    """The MLP bound in the JAX package, Xavier-initialised from the seed
    that ``tests/conftest.py`` sets (``mx.random.seed(0)``)."""
    exe = cs.build_mlp(mx.sym).simple_bind(
        mx.cpu(), grad_req="write", data=(BATCH, 784),
        softmax_label=(BATCH,))
    init = mx.init.Xavier()
    for n in cs.param_names(exe):
        init(mx.init.InitDesc(n), exe.arg_dict[n])
    return exe


def _jax_train(exe, x, y, steps):
    """The JAX package's step loop, the one ``Module.fit`` runs inside."""
    upd = mx.optimizer.Updater(mx.optimizer.SGD(
        learning_rate=cs.MLP_LR, momentum=cs.MLP_MOMENTUM,
        rescale_grad=1.0 / BATCH))
    params = cs.param_names(exe)
    losses, probs = [], []
    for i in range(steps):
        xb, yb = x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH]
        exe.forward(is_train=True, data=xb, softmax_label=yb)
        exe.backward()
        for j, n in enumerate(params):
            upd(j, exe.grad_dict[n], exe.arg_dict[n])
        p = exe.outputs[0].asnumpy()
        probs.append(p)
        losses.append(-np.log(p[np.arange(BATCH), yb.astype(int)]).mean())
    return losses, probs


def test_synthetic_digits_equal_jax():
    ours, theirs = mt.test_utils.get_mnist(), jax_get_mnist(path="no-such")
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_ten_steps_match_jax(kernels):
    x, y, _, _ = _data()
    jexe = _jax_exe()
    exe = cs.bind_mlp(mt.cpu())
    exe.copy_params_from(nd.params_from_jax(
        {n: jexe.arg_dict[n].asnumpy() for n in cs.param_names(jexe)}, exe))
    want_loss, want_probs = _jax_train(jexe, x, y, 10)
    y_nd = nd.array(y, ctx=mt.cpu())
    probs, _ = cs.train_mlp(exe, nd.array(x, ctx=mt.cpu()), y_nd, 10)
    # per-step batch loss and softmax outputs: fp32 forward in two orders
    np.testing.assert_allclose(cs.batch_losses(probs, y_nd).numpy(),
                               want_loss, rtol=0, atol=1e-5)
    for got, want in zip(probs, want_probs):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # weights after 10 momentum steps: the small per-step gaps accumulate
    for n in cs.param_names(exe):
        np.testing.assert_allclose(exe.arg_dict[n].asnumpy(),
                                   jexe.arg_dict[n].asnumpy(), rtol=0,
                                   atol=1e-4, err_msg=n)


def test_jax_reference_accuracy(kernels):
    """The figure ``chip_smoke.py`` holds the card to: the JAX package's
    test accuracy after one epoch of 64 steps on the CPU."""
    x, y, xt, yt = _data()
    jexe = _jax_exe()
    _jax_train(jexe, x, y, cs.MLP_STEPS)
    correct = 0
    for i in range(cs.MLP_EVAL_BATCHES):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        p = jexe.forward(is_train=False, data=xt[sl])[0].asnumpy()
        correct += int((p.argmax(axis=1) == yt[sl]).sum())
    assert correct / (BATCH * cs.MLP_EVAL_BATCHES) == cs.JAX_CPU_ACCURACY


def test_chip_smoke_mlp_phase_on_cpu(kernels):
    """The card's training phase, rehearsed on the CPU: the loss falls,
    the accuracy clears the JAX figure, and no kernel launches."""
    x, y, xt, yt = _data()
    exe = cs.bind_mlp(mt.cpu())
    cs.init_mlp(exe)
    mt.ops.scale.reset_launch_count()
    y_nd = nd.array(y, ctx=mt.cpu())
    probs, times = cs.train_mlp(exe, nd.array(x, ctx=mt.cpu()), y_nd,
                                cs.MLP_STEPS)
    losses = cs.batch_losses(probs, y_nd)
    acc = cs.eval_mlp(exe, nd.array(xt, ctx=mt.cpu()),
                      nd.array(yt, ctx=mt.cpu()))
    assert len(times) == cs.MLP_STEPS and losses.shape == (cs.MLP_STEPS,)
    assert float(losses[-1]) < float(losses[0])
    assert acc >= cs.JAX_CPU_ACCURACY - 0.02
    assert mt.ops.scale.launch_count() == 0


def test_xavier_and_name_rules():
    mt.random.seed(0)
    init = mt.init.Xavier()
    w = nd.zeros((128, 784), ctx=mt.cpu())
    init(mt.init.InitDesc("fc1_weight"), w)
    bound = np.sqrt(3.0 / ((784 + 128) / 2.0))
    vals = w.asnumpy()
    assert np.abs(vals).max() <= bound and np.abs(vals).max() > 0.99 * bound
    # U(-b, b) has standard deviation b / sqrt(3)
    assert abs(vals.std() - bound / np.sqrt(3)) < 0.01 * bound
    for name, want in (("fc1_bias", 0.0), ("bn_gamma", 1.0), ("bn_beta", 0.0),
                       ("bn_moving_var", 1.0)):
        arr = nd.full((3,), 5.0, ctx=mt.cpu())
        init(mt.init.InitDesc(name), arr)
        assert (arr.asnumpy() == want).all(), name
    with pytest.raises(ValueError):
        init(mt.init.InitDesc("unknown"), w)
    with pytest.raises(ValueError):
        init(mt.init.InitDesc("fc1_weight"), nd.zeros((3,), ctx=mt.cpu()))
    mt.init.Normal(0.5)(mt.init.InitDesc("x_weight"), w)
    assert abs(w.asnumpy().std() - 0.5) < 0.02


@pytest.mark.parametrize("momentum,wd,clip", [(0.0, 0.0, None),
                                              (0.9, 1e-3, 0.01)])
def test_sgd_updater_matches_jax(momentum, wd, clip):
    rng = np.random.RandomState(4)
    names = {0: "fc_weight", 1: "fc_bias"}
    shapes = {0: (4, 3), 1: (4,)}
    w0 = {i: rng.randn(*shapes[i]).astype(np.float32) for i in names}
    grads = [{i: rng.randn(*shapes[i]).astype(np.float32) for i in names}
             for _ in range(3)]
    out = []
    for pkg, ndm, ctx in ((mt, nd, mt.cpu()), (mx, mx.nd, mx.cpu())):
        upd = pkg.optimizer.Updater(pkg.optimizer.SGD(
            learning_rate=0.1, momentum=momentum, wd=wd, clip_gradient=clip,
            rescale_grad=0.5, param_idx2name=names))
        ws = {i: ndm.array(w0[i], ctx=ctx) for i in names}
        for step in grads:
            for i in names:
                upd(i, ndm.array(step[i], ctx=ctx), ws[i])
        out.append({i: ws[i].asnumpy() for i in names})
    for i in names:
        np.testing.assert_allclose(out[0][i], out[1][i], rtol=1e-6,
                                   atol=1e-6)
    # no weight decay on the bias (wd_mult 0 from its name)
    assert mt.optimizer.SGD(wd=0.1, param_idx2name=names)._get_wd(1) == 0.0
