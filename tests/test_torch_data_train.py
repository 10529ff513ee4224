"""The data slice as a whole against the JAX package on the CPU, in fp64.

- ``examples/train_mnist.py``'s LeNet through ``Module``: 3 fit steps
  (``_fit_step``, SGD lr 0.1, momentum 0.9) on batches of each package's
  ``MNISTIter`` over the same idx files, after one ``random.seed`` (the
  batches equal bit for bit), from one Xavier init, the JAX package
  through its two-call step (its one-call step rounds lr to fp32):
  outputs and parameters within 1e-9 (both sum the same fp64 products in
  other orders; a tanh net does not amplify rounding as a ReLU ResNet
  does).
- The thumbnail ``resnet18_v1`` through Gluon (``hybridize``,
  ``SoftmaxCrossEntropyLoss``, ``Trainer("sgd")``): 2 steps on batches of
  each package's ``ImageRecordIter`` over one ``.rec`` of 32 x 32 JPEGs
  (equal bit for bit), within 1e-6, ``tests/test_torch_gluon_train.py``'s
  bar for this net (ReLU branches flip within rounding).
- One epoch of LeNet in fp32 through ``Module.fit`` over ``MNISTIter``
  (2,048 synthetic digits, batch 64) in both packages: the port's test
  accuracy reaches the JAX package's less 0.02; the JAX package's figure
  is ``chip_smoke.LENET_JAX_CPU_ACCURACY``, the bar of the card's run.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx

import mxnet_tpu_torch as mt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


train_mnist = _load("train_mnist_example", "examples/train_mnist.py")
chip_smoke = _load("chip_smoke_for_tests", "chip_smoke.py")

LENET_BATCH, LENET_STEPS = 16, 3
SGD = (("learning_rate", 0.1), ("momentum", 0.9))


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    prev = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_enable_x64", prev[0])
    torch.set_num_threads(prev[1])


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    return mt.test_utils.write_mnist_idx(
        str(tmp_path_factory.mktemp("mnist")), 2048, 512)


def _mnist_iter(pkg, path, batch, train=True, shuffle=True):
    names = mt.test_utils.MNIST_FILES[:2] if train else \
        mt.test_utils.MNIST_FILES[2:]
    return pkg.io.MNISTIter(image=os.path.join(path, names[0]),
                            label=os.path.join(path, names[1]),
                            batch_size=batch, shuffle=shuffle)


def _host(params):
    return [{k: v.asnumpy().astype(np.float64) for k, v in d.items()}
            for d in params]


def _lenet_steps(pkg, path, init):
    ctx = pkg.cpu()
    mod = pkg.mod.Module(train_mnist.build_lenet(pkg), context=ctx)
    shape = (LENET_BATCH, 1, 28, 28)
    mod.bind(data_shapes=[pkg.io.DataDesc("data", shape, dtype="float64")],
             label_shapes=[pkg.io.DataDesc("softmax_label", shape[:1],
                                           dtype="float64")])
    arg, aux = init
    if pkg is mt:
        arg, aux = mt.mod.params_from_jax(arg, aux, mod.symbol, ctx=ctx,
                                          data_shapes=mod.data_shapes)
    else:
        arg, aux = [{k: mx.nd.array(v, dtype="float64") for k, v in d.items()}
                    for d in (arg, aux)]
    mod.set_params(arg, aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    pkg.random.seed(21)
    it = _mnist_iter(pkg, path, LENET_BATCH)
    outs, batches = [], []
    for _ in range(LENET_STEPS):
        b = it.next()
        x, y = b.data[0].asnumpy(), b.label[0].asnumpy()
        batches.append((x, y))
        kw = {"ctx": ctx} if pkg is mt else {}
        mod._fit_step(pkg.io.DataBatch(
            [pkg.nd.array(x, dtype="float64", **kw)],
            [pkg.nd.array(y, dtype="float64", **kw)]))
        outs.append(mod.get_outputs()[0].asnumpy().astype(np.float64))
    return outs, batches, _host(mod.get_params())


def test_lenet_mnist_iter_fit_steps_match_jax(mnist_dir, monkeypatch):
    jmod = mx.mod.Module(train_mnist.build_lenet(mx), context=mx.cpu())
    jmod.bind([("data", (LENET_BATCH, 1, 28, 28))],
              [("softmax_label", (LENET_BATCH,))])
    mx.random.seed(0)
    jmod.init_params(mx.init.Xavier())
    init = [{k: v.astype(np.float64) for k, v in d.items()}
            for d in _host(jmod.get_params())]
    pouts, pbatches, pparams = _lenet_steps(mt, mnist_dir, init)
    # the JAX package's one-call step rounds lr to fp32: its two-call path
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "0")
    jouts, jbatches, jparams = _lenet_steps(mx, mnist_dir, init)
    for (px, py), (jx, jy) in zip(pbatches, jbatches):
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)
    for a, b in zip(pouts, jouts):
        np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)
    for pa, ja in zip(pparams, jparams):
        for k in ja:
            np.testing.assert_allclose(pa[k], ja[k], atol=1e-9, rtol=0,
                                       err_msg=k)
    moved = max(np.abs(pparams[0][k] - init[0][k]).max() for k in init[0])
    assert moved > 1e-3


@pytest.fixture(scope="module")
def thumb_rec(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("rec") / "thumb")
    mt.test_utils.write_image_rec(prefix, 8, seed=2, short=40, classes=10)
    return prefix + ".rec"


def _thumb_run(pkg, rec, params, steps=2, batch=4):
    with pkg.cpu():
        with pkg.name.NameManager():
            net = pkg.gluon.model_zoo.vision.get_model(
                "resnet18_v1", thumbnail=True, classes=10)
        net.cast("float64")
        net.initialize()
        for n, p in net.collect_params().items():
            p.set_data(pkg.nd.array(params[n], dtype="float64"))
        net.hybridize()
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        kw = {"ctx": pkg.cpu()} if pkg is mt else {}
        it = pkg.image.ImageRecordIter(
            path_imgrec=rec, data_shape=(3, 32, 32), batch_size=batch,
            shuffle=True, rand_mirror=True, seed=5, preprocess_threads=2,
            **kw)
        outs, batches = [], []
        for _ in range(steps):
            b = it.next()
            batches.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
            x = b.data[0].astype("float64")
            y = b.label[0].astype("float64")
            with pkg.autograd.record():
                out = net(x)
                loss = loss_fn(out, y)
            loss.backward()
            trainer.step(batch)
            outs.append(out.asnumpy())
        return outs, batches, {n: p.data().asnumpy()
                               for n, p in net.collect_params().items()}


def test_thumbnail_resnet_image_record_iter_steps_match_jax(thumb_rec):
    with mx.name.NameManager():
        jnet = mx.gluon.model_zoo.vision.get_model("resnet18_v1",
                                                   thumbnail=True, classes=10)
    mx.random.seed(3)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.zeros((1, 3, 32, 32)))
    params = {n: p.data().asnumpy().astype(np.float64)
              for n, p in jnet.collect_params().items()}
    pouts, pb, pparams = _thumb_run(mt, thumb_rec, params)
    jouts, jb, jparams = _thumb_run(mx, thumb_rec, params)
    for (px, py), (jx, jy) in zip(pb, jb):
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)
    for a, b in zip(pouts, jouts):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    for n in jparams:
        np.testing.assert_allclose(pparams[n], jparams[n], atol=1e-6, rtol=0,
                                   err_msg=n)


def _lenet_epoch(pkg, path):
    kw = {"context": pkg.cpu()}
    mod = pkg.mod.Module(train_mnist.build_lenet(pkg), **kw)
    pkg.random.seed(0)
    train = _mnist_iter(pkg, path, 64)
    val = _mnist_iter(pkg, path, 64, train=False, shuffle=False)
    mod.fit(train, optimizer="sgd", initializer=pkg.init.Xavier(),
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            num_epoch=1)
    return mod.score(val, "acc")[0][1]


def test_lenet_one_epoch_accuracy_against_jax(mnist_dir):
    port, ref = _lenet_epoch(mt, mnist_dir), _lenet_epoch(mx, mnist_dir)
    print("LeNet, 1 epoch of 2048 digits at batch 64, test accuracy: port "
          "%.4f, JAX package %.4f" % (port, ref))
    assert port >= ref - 0.02
    assert ref == pytest.approx(chip_smoke.LENET_JAX_CPU_ACCURACY, abs=1e-9)
