"""Gluon ``Parameter``/``ParameterDict`` of the PyTorch package against
the JAX package: ``zero_grad``, ``reset_ctx`` and ``setattr`` with the
basics they act on.

Mirrors ``tests/test_gluon.py:11-28`` (``test_parameter``,
``test_paramdict``) in both packages.  Values are held equal bit for bit
(fp32, the same seeded draws and the same ops on the CPU).  The port's
captured programs hold the Parameters' tensors by address, so
``zero_grad`` must zero in place and ``reset_ctx`` must drop every
program that read the old tensors; a stand-in graph (``capture.
stand_in``) drives those programs on the CPU.
"""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import capture, profiler

PKGS = {"jax": mx, "torch": mt}


class StandInGraph:
    """``capture`` runs the stage once, ``replay`` runs it again and
    copies its results into the captured outputs."""
    warmup_runs = 0

    def __init__(self, device, pool, generators):
        pass

    @staticmethod
    def pool(device):
        return None

    def capture(self, fn):
        self._fn = fn
        self._outs = [o.detach() for o in fn()]
        return self._outs

    def replay(self):
        with torch.no_grad():
            for dst, src in zip(self._outs, self._fn()):
                dst.copy_(src)


@pytest.fixture(autouse=True)
def _cpu():
    profiler.reset_counters()
    with mt.cpu():
        yield


def test_parameter():
    for pkg in PKGS.values():
        p = pkg.gluon.Parameter("weight", shape=(10, 10))
        p.initialize(init="xavier", ctx=pkg.cpu())
        assert len(p.list_data()) == 1
        assert len(p.list_grad()) == 1
        assert p.data().shape == (10, 10)
        assert p.grad().shape == (10, 10)


def test_paramdict(tmp_path):
    values = {}
    for key, pkg in PKGS.items():
        params = pkg.gluon.ParameterDict("net_")
        params.get("weight", shape=(10, 10))
        assert list(params.keys()) == ["net_weight"]
        pkg.random.seed(2)
        params.initialize(ctx=pkg.cpu())
        f = str(tmp_path / ("%s.params" % key))
        params.save(f)
        params.load(f, pkg.cpu())
        values[key] = params["net_weight"].data().asnumpy()
    np.testing.assert_array_equal(values["torch"], values["jax"])


def _net(pkg, grad_req="write", seed=1):
    pkg.random.seed(seed)
    net = pkg.gluon.nn.HybridSequential(prefix="pz_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(5, activation="relu", in_units=4),
                pkg.gluon.nn.Dense(2, in_units=5))
    net.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
    if grad_req != "write":
        net.collect_params().setattr("grad_req", grad_req)
    return net


def _batch(pkg, seed=0):
    x = np.random.RandomState(seed).randn(3, 4).astype(np.float32)
    return pkg.nd.array(x, ctx=pkg.cpu())


def _backward(pkg, net, x):
    with pkg.autograd.record():
        loss = (net(x) ** 2).sum()
    loss.backward()


def _grads(net):
    return [p.grad().asnumpy().copy() for p in net.collect_params().values()]


@pytest.mark.parametrize("mode", ["eager", "captured"])
def test_zero_grad_clears_an_add_gradient(mode):
    """Two backwards, ``zero_grad``, one backward: one backward's
    gradients, bit for bit, as in the JAX package."""
    got = {}
    for key, pkg in PKGS.items():
        net, x = _net(pkg, "add"), _batch(pkg)
        if pkg is mt and mode == "captured":
            net.hybridize()
        ctx = capture.stand_in(StandInGraph) if pkg is mt \
            and mode == "captured" else contextlib.nullcontext()
        with ctx:
            _backward(pkg, net, x)
            twice = (_backward(pkg, net, x), _grads(net))[1]
            buffers = [p.grad()._data for p in net.collect_params().values()] \
                if pkg is mt else None
            net.collect_params().zero_grad()
            assert all((g == 0).all() for g in _grads(net))
            _backward(pkg, net, x)
            once = _grads(net)
        if buffers is not None:   # zeroed in place: the same tensors
            assert all(p.grad()._data is b for p, b in
                       zip(net.collect_params().values(), buffers))
        for a, b in zip(twice, once):
            np.testing.assert_array_equal(a, 2 * b)
        got[key] = once
    fresh = _net(mt, "add")
    _backward(mt, fresh, _batch(mt))
    for a, b in zip(got["torch"], _grads(fresh)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["torch"], got["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_reset_ctx_keeps_values_and_remakes_gradients():
    got = {}
    for key, pkg in PKGS.items():
        net, x = _net(pkg), _batch(pkg)
        params = net.collect_params()
        before = {n: p.data().asnumpy() for n, p in params.items()}
        params.reset_ctx(pkg.cpu_pinned())
        for n, p in params.items():
            assert p.list_ctx() == [pkg.cpu_pinned()]
            np.testing.assert_array_equal(p.data().asnumpy(), before[n])
        params.reset_ctx([pkg.cpu()])
        got[key] = net(x).asnumpy()
        _backward(pkg, net, x)
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=1e-6)
    net = _net(mt)
    params = net.collect_params()
    params.reset_ctx(mt.cpu_pinned())
    for p in params.values():
        assert p.data().context == mt.cpu_pinned()
        assert p.grad().context == mt.cpu_pinned()
        assert (p.grad().asnumpy() == 0).all()
    _backward(mt, net, _batch(mt))
    assert all(np.abs(g).max() > 0 for g in _grads(net))


def test_reset_ctx_drops_the_captured_programs():
    """A hybridized block's programs and the Trainer's fused update
    capture anew after ``reset_ctx``, and the outputs and the update
    are unchanged by the round trip."""
    x = _batch(mt)

    def run(net, trainer):
        with mt.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        trainer.step(3)
        return net(x).asnumpy()

    plain = _net(mt)
    plain_trainer = mt.gluon.Trainer(plain.collect_params(), "sgd",
                                     {"learning_rate": 0.1})
    want = [run(plain, plain_trainer) for _ in range(3)]

    net = _net(mt)
    net.hybridize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    with capture.stand_in(StandInGraph):
        first = run(net, trainer)
        caps = profiler.counter("graph_captures")
        second = run(net, trainer)
        assert profiler.counter("graph_captures") == caps
        held = len(trainer._programs)
        assert held == 1 and net._cached_op._programs
        net.collect_params().reset_ctx(mt.cpu_pinned())
        assert len(trainer._programs) == 0
        assert net._cached_op._programs == []
        net.collect_params().reset_ctx(mt.cpu())
        third = run(net, trainer)
        assert profiler.counter("graph_captures") == 2 * caps
    for a, b in zip((first, second, third), want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_reset_ctx_of_a_deferred_parameter():
    for pkg in PKGS.values():
        dense = pkg.gluon.nn.Dense(3)
        dense.initialize(ctx=pkg.cpu())
        dense.collect_params().reset_ctx(pkg.cpu_pinned())
        out = dense(pkg.nd.ones((2, 4), ctx=pkg.cpu()))
        assert out.shape == (2, 3)
        assert dense.weight.list_ctx() == [pkg.cpu_pinned()]


def test_setattr():
    for pkg in PKGS.values():
        net = _net(pkg)
        params = net.collect_params()
        params.setattr("lr_mult", 0.5)
        params.setattr("grad_req", "null")
        assert all(p.lr_mult == 0.5 and p.grad_req == "null"
                   for p in params.values())
        params.setattr("grad_req", "write")
        _backward(pkg, net, _batch(pkg))
        assert all(np.abs(g).max() > 0 for g in _grads(net))
