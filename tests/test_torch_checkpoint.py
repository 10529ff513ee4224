"""Checkpoints of the PyTorch package against the JAX package on the CPU:
``Module`` (``save_checkpoint``, ``Module.load``, the optimizer states),
Gluon (``Block.save_params``/``load_params``, ``Trainer.save_states``/
``load_states``), ``model.load_checkpoint`` and the epoch callbacks.

The JAX package's own cases (``tests/test_module.py::
test_module_checkpoint_roundtrip``, ``tests/test_gluon.py::
test_block_save_load_params``, the three cases of
``tests/test_fused_trainer.py:300-336`` and ``tests/test_cached_step.py::
test_fused_step_optimizer_state_checkpoint_roundtrip``) run here in both
packages.  Across the packages: a bound forward of each package's
checkpoint loaded by the other, and a ``Module`` (SGD momentum) and a
Gluon ``Trainer`` (SGD momentum and Adam) resumed from a file that the
*other* package wrote, which must continue bit for bit with the
uninterrupted run: package A trains 3 steps and saves, package B loads
and saves again, A loads B's files into fresh objects and trains 3 more
steps.  Then the captured steps (``capture.stand_in``): loading states
into a captured step captures again exactly once.

Tolerances.  Within a package a resumed run is held to its uninterrupted
run bit for bit, on one torch thread (the CPU's threaded reductions are
not bit reproducible; ``tests/test_torch_capture.py`` runs so too).
Between the packages: parameters after the same fp32 training, rtol 1e-5
and atol 1e-6 (the same operations summed in other orders); a bound
forward of ResNet-18 (thumbnail) in fp32, 1e-4 on the softmax outputs,
``tests/test_torch_module.py``'s limit for fp32 outputs before any
update.
"""
import contextlib
import importlib.util
import logging
import os
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import fused_trainer as jax_fused

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, capture, profiler
from mxnet_tpu_torch.gluon import fused_trainer as port_fused

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = (mx, mt)
FP32 = dict(rtol=1e-5, atol=1e-6)
SGD_MOM = (("learning_rate", 0.1), ("momentum", 0.9))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cap = _load("test_torch_capture", "tests/test_torch_capture.py")
ser = _load("test_torch_serialization", "tests/test_torch_serialization.py")
bits = ser.bits


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    profiler.reset_counters()
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def fused_env():
    """Set ``MXNET_FUSED_TRAINER`` for both packages; restored after."""
    prev = os.environ.get("MXNET_FUSED_TRAINER")

    def set_(value):
        os.environ["MXNET_FUSED_TRAINER"] = value
        jax_fused.refresh_from_env()
        port_fused.refresh_from_env()
    yield set_
    if prev is None:
        os.environ.pop("MXNET_FUSED_TRAINER", None)
    else:
        os.environ["MXNET_FUSED_TRAINER"] = prev
    jax_fused.refresh_from_env()
    port_fused.refresh_from_env()


def _other(pkg):
    return mt if pkg is mx else mx


def _same_bits(a, b, what=""):
    """Two {name: NDArray} dicts (or lists) of either package, bit for
    bit."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        pairs = [(k, a[k], b[k]) for k in sorted(a)]
    else:
        pairs = [(i, x, y) for i, (x, y) in enumerate(zip(a, b))]
    for k, x, y in pairs:
        bx, by = bits(x), bits(y)
        assert bx.dtype == by.dtype and bx.shape == by.shape, (what, k)
        assert np.array_equal(bx, by), (what, k)


# -- tests/test_module.py ------------------------------------------------------
def _mlp_sym(pkg):
    s = pkg.sym
    with pkg.name.NameManager():
        net = s.FullyConnected(s.var("data"), num_hidden=32, name="fc1")
        net = s.Activation(net, act_type="relu")
        net = s.FullyConnected(net, num_hidden=10, name="fc2")
        return s.SoftmaxOutput(net, name="softmax")


def _blob_data(n=600, d=50, k=10, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, k, n)
    centers = rng.randn(k, d).astype(np.float32) * 2
    X = centers[y] + rng.randn(n, d).astype(np.float32) * 0.4
    return X, y.astype(np.float32)


def test_module_checkpoint_roundtrip(tmp_path):
    X, y = _blob_data(n=200)
    params, files = {}, {}
    for pkg in PACKAGES:
        train = pkg.io.NDArrayIter(X, y, batch_size=50)
        pkg.random.seed(0)
        mod = pkg.mod.Module(_mlp_sym(pkg), context=pkg.cpu())
        mod.fit(train, num_epoch=1, optimizer_params={"learning_rate": 0.1})
        prefix = str(tmp_path / ("chk_%s" % pkg.__name__))
        mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
        mod2 = pkg.mod.Module.load(prefix, 1, context=pkg.cpu())
        mod2.bind(data_shapes=train.provide_data,
                  label_shapes=train.provide_label, for_training=False)
        p1, _ = mod.get_params()
        p2, _ = mod2.get_params()
        _same_bits(p1, p2, pkg.__name__)
        params[pkg], files[pkg] = p1, prefix
    for k in params[mx]:
        np.testing.assert_allclose(params[mt][k].asnumpy(),
                                   params[mx][k].asnumpy(), **FP32)
    for reader in PACKAGES:
        writer = _other(reader)
        _, arg, aux = reader.model.load_checkpoint(files[writer], 1)
        _same_bits(arg, params[writer])
        assert aux == {}


# -- tests/test_gluon.py -------------------------------------------------------
def test_block_save_load_params(tmp_path):
    outs = {}
    for pkg in PACKAGES:
        f = str(tmp_path / ("block_%s.params" % pkg.__name__))
        nn = pkg.gluon.nn
        with pkg.cpu():
            pkg.random.seed(0)
            net = nn.HybridSequential(prefix="sl_")
            with net.name_scope():
                net.add(nn.Dense(4, in_units=3))
            net.initialize()
            net.save_params(f)
            net2 = nn.HybridSequential(prefix="sl_")
            with net2.name_scope():
                net2.add(nn.Dense(4, in_units=3))
            net2.load_params(f)
            x = pkg.nd.ones((2, 3))
            np.testing.assert_array_equal(net(x).asnumpy(),
                                          net2(x).asnumpy())
            outs[pkg] = net2(x).asnumpy()
    assert open(str(tmp_path / "block_mxnet_tpu.params"), "rb").read() \
        == open(str(tmp_path / "block_mxnet_tpu_torch.params"), "rb").read()
    np.testing.assert_allclose(outs[mt], outs[mx], **FP32)


def test_parameter_dict_load_rules(tmp_path):
    """``allow_missing``, ``ignore_extra`` and the prefixes, with the JAX
    package's errors."""
    f = str(tmp_path / "p.params")
    for pkg in PACKAGES:
        with pkg.cpu():
            pkg.nd.save(f, {"arg:w": pkg.nd.ones((2,)),
                            "x": pkg.nd.zeros((1,))})
            params = pkg.gluon.ParameterDict("net_")
            params.get("w", shape=(2,))
            params.get("b", shape=(3,))
            with pytest.raises(IOError, match="net_b is missing"):
                params.load(f, restore_prefix="net_", ignore_extra=True)
            with pytest.raises(IOError, match="not present"):
                params.load(f, restore_prefix="net_", allow_missing=True)
            params.load(f, restore_prefix="net_", allow_missing=True,
                        ignore_extra=True)
            np.testing.assert_array_equal(params["net_w"].data().asnumpy(),
                                          np.ones(2))
            with pytest.raises(ValueError, match="striped"):
                params.save(f, strip_prefix="other_")


def test_load_params_takes_ctx_for_uninitialized_parameters(tmp_path):
    f = str(tmp_path / "d.params")
    with mt.cpu():
        net = mt.gluon.nn.Dense(2, in_units=3, prefix="d_")
        net.initialize()
        net.save_params(f)
    fresh = mt.gluon.nn.Dense(2, in_units=3, prefix="d_")
    fresh.load_params(f, ctx=mt.cpu())
    assert fresh.weight.data().context == mt.cpu()
    _same_bits([fresh.weight.data()], [net.weight.data()])


# -- tests/test_fused_trainer.py:300-336 ---------------------------------------
def _net(pkg):
    nn = pkg.gluon.nn
    net = nn.Sequential()
    for _ in range(2):
        net.add(nn.Dense(8, activation="relu"))
    net.add(nn.Dense(3))
    return net


def _train(pkg, optimizer, opt_params, steps=4, seed=0):
    """``tests/test_fused_trainer.py::_train``'s net and data."""
    with pkg.cpu():
        np.random.seed(seed)
        pkg.random.seed(seed)
        rng = np.random.RandomState(seed + 1)
        net = _net(pkg)
        net.initialize(init=pkg.initializer.Xavier())
        trainer = pkg.gluon.Trainer(net.collect_params(), optimizer,
                                    dict(opt_params))
        loss_fn = pkg.gluon.loss.L2Loss()
        X = rng.randn(steps, 16, 6).astype(np.float32)
        Y = rng.randn(steps, 16, 3).astype(np.float32)
        for step in range(steps):
            with pkg.autograd.record():
                loss = loss_fn(net(pkg.nd.array(X[step])),
                               pkg.nd.array(Y[step]))
            loss.backward()
            trainer.step(16)
    return net, trainer


def _trajectory(pkg, total_steps, reload_at=None, tmp_path=None):
    """``tests/test_fused_trainer.py::_trajectory``: per-step losses of an
    Adam run, checkpointed into a fresh Trainer at ``reload_at``."""
    with pkg.cpu():
        np.random.seed(0)
        pkg.random.seed(0)
        rng = np.random.RandomState(1)
        X = rng.randn(total_steps, 8, 6).astype(np.float32)
        Y = rng.randn(total_steps, 8, 3).astype(np.float32)

        def fresh():
            net = _net(pkg)
            net.initialize(init=pkg.initializer.Xavier())
            return net, pkg.gluon.Trainer(net.collect_params(), "adam",
                                          {"learning_rate": 0.05})

        net, trainer = fresh()
        loss_fn = pkg.gluon.loss.L2Loss()
        losses = []
        for step in range(total_steps):
            if reload_at is not None and step == reload_at:
                fname = str(tmp_path / ("trainer_%s.states" % pkg.__name__))
                trainer.save_states(fname)
                weights = [p.data().asnumpy()
                           for p in net.collect_params().values()]
                net, trainer = fresh()
                for p, w in zip(net.collect_params().values(), weights):
                    p.set_data(pkg.nd.array(w))
                trainer.load_states(fname)
            with pkg.autograd.record():
                loss = loss_fn(net(pkg.nd.array(X[step])),
                               pkg.nd.array(Y[step]))
            loss.backward()
            trainer.step(8)
            losses.append(float(np.float64(loss.asnumpy().sum())))
    return losses


def test_save_load_step_bitwise_roundtrip(tmp_path, fused_env):
    """save_states, a fresh Trainer, load_states: Adam continues bit for
    bit (its t included), fused and per-parameter alike, which agree with
    each other; the port's trajectory within fp32 of the JAX package's."""
    ref_by_pkg = {}
    for pkg in PACKAGES:
        by_path = {}
        for fused in ("1", "0"):
            fused_env(fused)
            ref = _trajectory(pkg, 5)
            resumed = _trajectory(pkg, 5, reload_at=3, tmp_path=tmp_path)
            assert resumed == ref, (pkg.__name__, fused)
            by_path[fused] = ref
        assert by_path["1"] == by_path["0"]
        ref_by_pkg[pkg] = by_path["1"]
    np.testing.assert_allclose(ref_by_pkg[mt], ref_by_pkg[mx], rtol=1e-5)


def test_load_states_accepts_legacy_blob(tmp_path):
    """A states file holding the Updater's pickle alone (no version
    marker) loads, written by either package."""
    trainers = {pkg: _train(pkg, "sgd", SGD_MOM)[1] for pkg in PACKAGES}
    for reader in PACKAGES:
        for writer in PACKAGES:
            f = str(tmp_path / ("legacy_%s.states" % writer.__name__))
            with open(f, "wb") as fh:
                fh.write(trainers[writer]._updater.get_states())
            _, fresh = _train(reader, "sgd", SGD_MOM, steps=1)
            fresh.load_states(f)
            for idx, st in trainers[writer]._updater.states.items():
                if st is not None:
                    _same_bits([st], [fresh._updater.states[idx]])


def test_fused_save_load_states_roundtrip(tmp_path):
    """The fused path's states load into a fresh Trainer of either
    package, with their update counts."""
    trainers = {pkg: _train(pkg, "sgd", SGD_MOM)[1] for pkg in PACKAGES}
    for reader in PACKAGES:
        for writer in PACKAGES:
            f = str(tmp_path / ("t_%s.states" % writer.__name__))
            trainers[writer].save_states(f)
            _, fresh = _train(reader, "sgd", SGD_MOM, steps=1)
            fresh.load_states(f)
            for idx, st in trainers[writer]._updater.states.items():
                if st is not None:
                    _same_bits([st], [fresh._updater.states[idx]])
            opt = fresh._optimizer
            assert opt._index_update_count == {i: 4 for i in range(6)}
            assert opt.num_update == 4


# -- tests/test_cached_step.py -------------------------------------------------
def test_fused_step_optimizer_state_checkpoint_roundtrip(tmp_path):
    states = {}
    for pkg in PACKAGES:
        f = str(tmp_path / ("opt_%s.states" % pkg.__name__))
        mod = cap._fit_module(pkg)
        assert mod._cached_step is not None
        mod.save_optimizer_states(f)
        mod2 = cap._fit_module(pkg, num_epoch=1)
        mod2.load_optimizer_states(f)
        for idx, st in mod._updater.states.items():
            if st is not None:
                _same_bits([st], [mod2._updater.states[idx]])
        states[pkg] = f
    for reader in PACKAGES:
        mod = cap._fit_module(reader, num_epoch=0)
        mod.load_optimizer_states(states[_other(reader)])
        assert sorted(mod._updater.states) == [0, 1, 2, 3]


# -- across the packages -------------------------------------------------------
@pytest.mark.parametrize("writer", PACKAGES, ids=lambda p: p.__name__)
def test_bound_forward_of_the_others_checkpoint(tmp_path, writer):
    """ResNet-18 (thumbnail) saved by one package, loaded by the other:
    both bind it for inference and agree on a batch."""
    prefix = str(tmp_path / "r18")
    shape = (2, 3, 32, 32)
    x = np.random.RandomState(2).rand(*shape).astype(np.float32)

    def bound(pkg, symbol, arg, aux):
        mod = pkg.mod.Module(symbol, context=pkg.cpu())
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (2,))], for_training=False)
        mod.set_params(arg, aux)
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())],
                                     [pkg.nd.zeros((2,), ctx=pkg.cpu())]),
                    is_train=False)
        return mod.get_outputs()[0].asnumpy()

    symbol = ser._resnet18(writer)
    mod = writer.mod.Module(symbol, context=writer.cpu())
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (2,))])
    writer.random.seed(0)
    mod.init_params(initializer=writer.initializer.Xavier())
    arg, aux = mod.get_params()
    rng = np.random.RandomState(3)
    for name in aux:  # moving statistics that the forward reads
        aux[name][:] = rng.rand(*aux[name].shape).astype(np.float32) + 0.5
    writer.model.save_checkpoint(prefix, 0, symbol, arg, aux)
    want = bound(writer, symbol, arg, aux)
    reader = _other(writer)
    rsym, rarg, raux = reader.model.load_checkpoint(prefix, 0)
    _same_bits(rarg, arg)
    _same_bits(raux, aux)
    got = bound(reader, rsym, rarg, raux)
    assert got.shape == (2, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)


def _batches(pkg, n=6):
    rng = np.random.RandomState(8)
    return [pkg.io.DataBatch([pkg.nd.array(rng.randn(8, 6), ctx=pkg.cpu())],
                             [pkg.nd.array(rng.randint(0, 3, (8,)),
                                           ctx=pkg.cpu())])
            for _ in range(n)]


def _bind_for(pkg, mod):
    it = cap._data_iter(pkg)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD_MOM)
    return mod


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p.__name__)
def test_module_resumes_bitwise_from_the_others_files(tmp_path, pkg):
    """``pkg`` trains 3 steps and saves; the other package loads the
    checkpoint and saves it again; ``pkg`` loads those files into a new
    Module and trains 3 more steps: bit for bit its uninterrupted run's
    parameters and momenta."""
    init = cap._host_params(cap._fit_module(mx, num_epoch=0))
    batches = _batches(pkg)
    whole = cap._fit_module(pkg, num_epoch=0, init=init)
    for b in batches:
        whole._fit_step(b)
    part = cap._fit_module(pkg, num_epoch=0, init=init)
    for b in batches[:3]:
        part._fit_step(b)
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    part.save_checkpoint(mine, 3, save_optimizer_states=True)
    other = _other(pkg)
    relay = _bind_for(other, other.mod.Module.load(
        mine, 3, load_optimizer_states=True, context=other.cpu()))
    relay.save_checkpoint(theirs, 3, save_optimizer_states=True)
    for ext in ("-0003.params", "-0003.states"):
        assert os.path.getsize(mine + ext) > 0
    assert open(mine + "-0003.params", "rb").read() \
        == open(theirs + "-0003.params", "rb").read()
    resumed = _bind_for(pkg, pkg.mod.Module.load(
        theirs, 3, load_optimizer_states=True, context=pkg.cpu()))
    for b in batches[3:]:
        resumed._fit_step(b)
    for a, b in zip(whole.get_params(), resumed.get_params()):
        _same_bits(a, b)
    for idx, st in whole._updater.states.items():
        _same_bits([st], [resumed._updater.states[idx]])


def _gluon_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="ck_")
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu", in_units=6))
        net.add(nn.Dense(3, in_units=8))
    pkg.random.seed(0)
    net.initialize(init=pkg.initializer.Xavier())
    return net


def _gluon_steps(pkg, net, trainer, data):
    loss_fn = pkg.gluon.loss.L2Loss()
    for x, y in data:
        with pkg.autograd.record():
            loss = loss_fn(net(pkg.nd.array(x)), pkg.nd.array(y))
        loss.backward()
        trainer.step(x.shape[0])


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p.__name__)
@pytest.mark.parametrize("optimizer,params", [
    ("sgd", dict(SGD_MOM)), ("adam", {"learning_rate": 0.05})],
    ids=["sgd_momentum", "adam"])
def test_trainer_resumes_bitwise_from_the_others_files(tmp_path, pkg,
                                                       optimizer, params):
    """As the Module case, through ``Block.save_params`` and
    ``Trainer.save_states``: Adam's bias correction reads the restored
    t."""
    rng = np.random.RandomState(6)
    data = [(rng.randn(8, 6).astype(np.float32),
             rng.randn(8, 3).astype(np.float32)) for _ in range(6)]
    other = _other(pkg)

    def fresh(p):
        net = _gluon_net(p)
        return net, p.gluon.Trainer(net.collect_params(), optimizer,
                                    dict(params))

    with pkg.cpu():
        net, trainer = fresh(pkg)
        _gluon_steps(pkg, net, trainer, data)
        whole = [p.data() for p in net.collect_params().values()]
        net, trainer = fresh(pkg)
        _gluon_steps(pkg, net, trainer, data[:3])
        net.save_params(str(tmp_path / "mine.params"))
        trainer.save_states(str(tmp_path / "mine.states"))
    with other.cpu():
        rnet, rtrainer = fresh(other)
        rnet.load_params(str(tmp_path / "mine.params"))
        rtrainer.load_states(str(tmp_path / "mine.states"))
        rnet.save_params(str(tmp_path / "theirs.params"))
        rtrainer.save_states(str(tmp_path / "theirs.states"))
    with pkg.cpu():
        net, trainer = fresh(pkg)
        net.load_params(str(tmp_path / "theirs.params"))
        trainer.load_states(str(tmp_path / "theirs.states"))
        assert trainer._optimizer.num_update == 3
        _gluon_steps(pkg, net, trainer, data[3:])
        _same_bits(whole, [p.data() for p in net.collect_params().values()])


# -- captured steps --------------------------------------------------------------
def test_load_optimizer_states_recaptures_once(tmp_path):
    """``load_optimizer_states`` on a captured Module step: the next step
    captures again, exactly once, and the run equals the eager one."""
    init = cap._host_params(cap._fit_module(mx, num_epoch=0))
    f = str(tmp_path / "m.states")
    cap._fit_module(mt, num_epoch=1, init=init).save_optimizer_states(f)

    def run(captured):
        with capture.stand_in(cap.StandInGraph) if captured \
                else contextlib.nullcontext():
            mod = cap._fit_module(mt, num_epoch=1, init=init)
            before = profiler.counter("graph_captures")
            mod.load_optimizer_states(f)
            mod.fit(cap._data_iter(mt), num_epoch=1)
            after_one = profiler.counter("graph_captures") - before
            mod.fit(cap._data_iter(mt), num_epoch=1)
            total = profiler.counter("graph_captures") - before
        return cap._host_params(mod)[0], after_one, total
    got, after_one, total = run(True)
    want, _, _ = run(False)
    assert (after_one, total) == (1, 1)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_trainer_load_states_recaptures_once(tmp_path):
    """``Trainer.load_states`` on a captured fused step (and a hybridized
    block): one more capture of the update, none after; bit for bit with
    eager."""
    rng = np.random.RandomState(7)
    data = [(rng.randn(8, 6).astype(np.float32),
             rng.randn(8, 3).astype(np.float32)) for _ in range(4)]
    f = str(tmp_path / "t.states")
    with mt.cpu():
        net = _gluon_net(mt)
        trainer = mt.gluon.Trainer(net.collect_params(), "adam")
        _gluon_steps(mt, net, trainer, data[:2])
        trainer.save_states(f)

    def run(captured):
        with capture.stand_in(cap.StandInGraph) if captured \
                else contextlib.nullcontext(), mt.cpu():
            net = _gluon_net(mt)
            net.hybridize()
            trainer = mt.gluon.Trainer(net.collect_params(), "adam")
            _gluon_steps(mt, net, trainer, data[:2])
            before = profiler.counter("graph_captures")
            trainer.load_states(f)
            _gluon_steps(mt, net, trainer, data[2:3])
            after_one = profiler.counter("graph_captures") - before
            _gluon_steps(mt, net, trainer, data[3:])
            total = profiler.counter("graph_captures") - before
        return [p.data().asnumpy() for p in
                net.collect_params().values()], after_one, total
    got, after_one, total = run(True)
    want, _, _ = run(False)
    assert (after_one, total) == (1, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_captured_resume_from_module_load(tmp_path):
    """``Module.load(..., load_optimizer_states=True)`` resumed captured:
    one capture, then one replay a step, bit for bit with the
    uninterrupted captured run."""
    init = cap._host_params(cap._fit_module(mx, num_epoch=0))
    batches = _batches(mt)
    with capture.stand_in(cap.StandInGraph):
        whole = cap._fit_module(mt, num_epoch=0, init=init)
        for b in batches:
            whole._fit_step(b)
        part = cap._fit_module(mt, num_epoch=0, init=init)
        for b in batches[:3]:
            part._fit_step(b)
        prefix = str(tmp_path / "c")
        part.save_checkpoint(prefix, 3, save_optimizer_states=True)
        resumed = _bind_for(mt, mt.mod.Module.load(
            prefix, 3, load_optimizer_states=True, context=mt.cpu()))
        before = cap._counts()
        for b in batches[3:]:
            resumed._fit_step(b)
        delta = [x - y for x, y in zip(cap._counts(), before)]
    assert delta == [1, 3, 3]
    for a, b in zip(whole.get_params(), resumed.get_params()):
        _same_bits(a, b)


# -- chip_smoke.py phase 19, on the CPU at a small size -------------------------
@pytest.mark.parametrize("kind", ["module", "gluon"])
def test_chip_smoke_checkpoint_phase_on_the_cpu(tmp_path, kind):
    """Phase 19's runs (``checkpoint_module_runs``,
    ``checkpoint_gluon_runs``) and its verdict, captured through the
    stand-in, on the thumbnail ResNet-18 at batch 2: the resume bit for
    bit, the files bit for bit, one capture of each program."""
    smoke = _load("chip_smoke", "chip_smoke.py")
    runs = {"module": (smoke.checkpoint_module_runs, 1),
            "gluon": (smoke.checkpoint_gluon_runs, 3)}[kind]
    with capture.stand_in(cap.StandInGraph):
        res = runs[0](mt.cpu(), torch.float32, str(tmp_path), batch=2,
                      image=32, model="resnet18_v1", classes=10,
                      thumbnail=True)
        summary = smoke.resume_verdict(kind, res, runs[1])
    assert summary["bitwise"] and summary["rerun_bits_differ"] == 0
    assert summary["file_bits_differ"] == 0
    assert summary["counts_resumed"]["graph_captures"] == runs[1]


# -- callbacks -----------------------------------------------------------------
def test_fit_resumes_from_do_checkpoint(tmp_path):
    """``fit(epoch_end_callback=do_checkpoint(prefix))``, then
    ``Module.load`` and ``fit(begin_epoch=1)``: bit for bit the
    uninterrupted two epochs; the JAX package reads the files."""
    init = cap._host_params(cap._fit_module(mx, num_epoch=0))
    whole = cap._fit_module(mt, num_epoch=0, init=init)
    whole.fit(cap._data_iter(mt), num_epoch=2, optimizer_params=SGD_MOM)
    part = cap._fit_module(mt, num_epoch=0, init=init)
    prefix, full = str(tmp_path / "cb"), str(tmp_path / "full")
    part.fit(cap._data_iter(mt), num_epoch=1, optimizer_params=SGD_MOM,
             epoch_end_callback=[
                 mt.callback.do_checkpoint(prefix),
                 mt.callback.module_checkpoint(part, full,
                                               save_optimizer_states=True)])
    assert open(prefix + "-0001.params", "rb").read() \
        == open(full + "-0001.params", "rb").read()
    resumed = mt.mod.Module.load(full, 1, load_optimizer_states=True,
                                 context=mt.cpu())
    with pytest.warns(UserWarning, match="already initialized"):
        resumed.fit(cap._data_iter(mt), begin_epoch=1, num_epoch=2,
                    optimizer_params=SGD_MOM)
    for a, b in zip(whole.get_params(), resumed.get_params()):
        _same_bits(a, b)
    sym, arg, aux = mx.model.load_checkpoint(prefix, 1)
    assert sym.list_arguments() == part.symbol.list_arguments()
    _same_bits(arg, part.get_params()[0])
    with pytest.raises(MXNetError, match="A.11"):
        mt.callback.do_checkpoint(prefix, async_write=True)


def test_log_callbacks_match_the_reference(caplog):
    """``log_train_metric``, ``ProgressBar`` and ``Speedometer`` log what
    the JAX package's log, on the same metric."""
    labels = np.array([0, 1, 2, 1], np.float32)
    preds = np.eye(3, dtype=np.float32)[[0, 1, 1, 1]]
    logs = {}
    for pkg in PACKAGES:
        metric = pkg.metric.Accuracy()
        metric.update([pkg.nd.array(labels, ctx=pkg.cpu())],
                      [pkg.nd.array(preds, ctx=pkg.cpu())])
        caplog.clear()
        with caplog.at_level(logging.INFO):
            log_cb = pkg.callback.log_train_metric(2)
            bar = pkg.callback.ProgressBar(4, length=8)
            speed = pkg.callback.Speedometer(4, frequent=2,
                                             auto_reset=False)
            for nbatch in range(5):
                param = types.SimpleNamespace(epoch=1, nbatch=nbatch,
                                              eval_metric=metric)
                log_cb(param)
                bar(param)
                speed(param)
        logs[pkg] = [r.getMessage() for r in caplog.records]
    strip = [m.split("Speed:")[0] + m.split("samples/sec")[-1]
             for m in logs[mt]]
    assert strip == [m.split("Speed:")[0] + m.split("samples/sec")[-1]
                     for m in logs[mx]]
    assert sum("Speed:" in m for m in logs[mt]) == 2
    assert "Iter[1] Batch[2] Train-accuracy=0.750000" in logs[mt]
