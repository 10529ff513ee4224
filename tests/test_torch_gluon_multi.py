"""Gluon on several contexts (``cpu(i)``, one process) against the JAX
package on the CPU: ``split_and_load`` even and uneven, a Parameter's
one buffer over a context list (``list_data``, ``list_grad``,
``list_ctx``), and a Dense MLP initialized on ``[cpu(0), cpu(1)]`` and
trained through ``Trainer`` under each kind of kvstore.

The reference keeps one buffer for a Parameter's context list and cannot
run a slice on ``cpu(1)`` against it (its arrays on two devices refuse
one program), so its run takes the whole batch on ``cpu(0)``; the port's
run takes ``split_and_load``'s slices on ``cpu(0)`` and ``cpu(1)`` and
one ``autograd.backward`` over their losses, whose gradient is the whole
batch's.  The reference runs with ``MXNET_FUSED_TRAINER=0``: its fused
step rounds lr and wd to fp32 (ROADMAP "Not faults").

Tolerance: fp64, the slices' gradients summed in another order than the
whole batch's, three SGD-momentum steps: 1e-12 of max(1, |value|).
"""
import os

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx
from mxnet_tpu.gluon import fused_trainer as jax_fused

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import fused_trainer as port_fused

FP64_TOL = 1e-12
BATCH, STEPS = 8, 3


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    prev = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_enable_x64", prev[0])
    torch.set_num_threads(prev[1])


@pytest.fixture
def fused_env():
    """Set ``MXNET_FUSED_TRAINER`` for both packages; restored after."""
    prev = os.environ.get("MXNET_FUSED_TRAINER")

    def set_to(value):
        os.environ["MXNET_FUSED_TRAINER"] = value
        jax_fused.refresh_from_env()
        port_fused.refresh_from_env()
    yield set_to
    if prev is None:
        os.environ.pop("MXNET_FUSED_TRAINER", None)
    else:
        os.environ["MXNET_FUSED_TRAINER"] = prev
    jax_fused.refresh_from_env()
    port_fused.refresh_from_env()


@pytest.mark.parametrize("n_ctx,rows,even", [(2, 8, True), (3, 9, True),
                                             (2, 7, False), (3, 8, False)])
def test_split_and_load_matches_reference(n_ctx, rows, even):
    """Each slice's rows and context, as the reference gives them."""
    x = np.random.RandomState(rows).randn(rows, 3).astype("float32")
    res = []
    for pkg in (mt, mx):
        parts = pkg.gluon.utils.split_and_load(
            x, [pkg.cpu(i) for i in range(n_ctx)], even_split=even)
        res.append([(str(p.context), p.asnumpy()) for p in parts])
    port, ref = res
    assert [c for c, _ in port] == [c for c, _ in ref] \
        == ["cpu(%d)" % i for i in range(n_ctx)]
    for (_, a), (_, b) in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        mt.gluon.utils.split_and_load(np.ones((2, 3)),
                                      [mt.cpu(i) for i in range(3)])


def test_uneven_split_refused_when_even_asked():
    for pkg in (mt, mx):
        with pytest.raises(ValueError):
            pkg.gluon.utils.split_and_load(np.ones((7, 3)),
                                           [pkg.cpu(0), pkg.cpu(1)])


def test_list_data_grad_ctx_match_reference():
    """One buffer whatever the context list: ``list_data``/``list_grad``
    repeat it once a context, ``data(cpu(1))`` is it, ``list_ctx`` is the
    list."""
    for pkg in (mt, mx):
        net = pkg.gluon.nn.Dense(3, in_units=4)
        ctxs = [pkg.cpu(0), pkg.cpu(1), pkg.cpu(2)]
        net.initialize(pkg.init.Uniform(0.1), ctx=ctxs)
        p = net.weight
        assert p.list_ctx() == ctxs
        data, grads = p.list_data(), p.list_grad()
        assert len(data) == len(grads) == 3
        assert all(d is p.data() for d in data)
        assert all(g is p.grad() for g in grads)
        assert p.data(pkg.cpu(1)) is p.data()
        assert p.grad(pkg.cpu(2)) is p.grad()
        assert str(p.data().context) == "cpu(0)"
    fresh = mt.gluon.Parameter("w", shape=(2,))
    with pytest.raises(RuntimeError):
        fresh.list_ctx()


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(16, activation="relu", in_units=6))
        net.add(pkg.gluon.nn.Dense(4, in_units=16))
    return net


def _init_params(seed=2):
    rng = np.random.RandomState(seed)
    return {"mlp_dense0_weight": rng.randn(16, 6) * 0.3,
            "mlp_dense0_bias": rng.randn(16) * 0.1,
            "mlp_dense1_weight": rng.randn(4, 16) * 0.3,
            "mlp_dense1_bias": rng.randn(4) * 0.1}


def _data(seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(BATCH, 6), rng.randint(0, 4, BATCH).astype("float64"))
            for _ in range(STEPS)]


def _gluon_run(pkg, kvstore, ctxs, split):
    """STEPS SGD-momentum steps of the MLP on ``ctxs`` (fp64): per slice
    of ``split_and_load`` with one backward over the slices' losses, or
    on the whole batch on ``ctxs[0]``.  Returns the weights and the
    store's type."""
    net = _mlp(pkg)
    net.initialize(ctx=ctxs)
    net.cast("float64")
    for name, value in _init_params().items():
        net.collect_params()[name].set_data(
            pkg.nd.array(value, ctx=ctxs[0], dtype="float64"))
    kv = pkg.kv.create("device") if kvstore == "kvstore_instance" \
        else kvstore
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9,
                                 "wd": 1e-4}, kvstore=kv)
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in _data():
        if split:
            xs = pkg.gluon.utils.split_and_load(
                pkg.nd.array(x, ctx=ctxs[0], dtype="float64"), ctxs)
            ys = pkg.gluon.utils.split_and_load(
                pkg.nd.array(y, ctx=ctxs[0], dtype="float64"), ctxs)
            with pkg.autograd.record():
                losses = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
            pkg.autograd.backward(losses)
        else:
            with pkg.autograd.record():
                loss = loss_fn(net(pkg.nd.array(x, ctx=ctxs[0],
                                                dtype="float64")),
                               pkg.nd.array(y, ctx=ctxs[0], dtype="float64"))
            loss.backward()
        trainer.step(BATCH)
    weights = {k: p.data().asnumpy()
               for k, p in net.collect_params().items()}
    return weights, trainer._kvstore


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("kvstore", [None, "device", "local",
                                     "kvstore_instance"])
def test_mlp_two_contexts_matches_reference(fused_env, kvstore, fused):
    """Three steps of the MLP over ``[cpu(0), cpu(1)]`` in fp64, the port
    through ``split_and_load`` (fused step and loop), equal to the
    reference's loop on the whole batch; a store is made at the first
    step unless the spec is None."""
    fused_env("0")
    want, ref_kv = _gluon_run(mx, kvstore, [mx.cpu(0), mx.cpu(1)], False)
    fused_env(fused)
    before = port_fused.fused_update_count()
    got, kv = _gluon_run(mt, kvstore, [mt.cpu(0), mt.cpu(1)], True)
    assert (port_fused.fused_update_count() - before) == \
        (STEPS if fused == "1" else 0)
    assert (kv is None) == (ref_kv is None) == (kvstore is None)
    if kv is not None:
        assert kv.type == ref_kv.type
    for k in want:
        scale = np.maximum(1.0, np.abs(want[k]))
        assert np.max(np.abs(got[k] - want[k]) / scale) <= FP64_TOL, k


def test_trainer_store_round_on_one_copy_moves_nothing(fused_env):
    """The fused step's store round over a Parameter's one buffer: one
    push-pull round a step, no reduce and no program counted, the
    gradients handed back as they are."""
    fused_env("1")
    with mt.cpu():
        net = _mlp(mt)
        net.initialize(ctx=[mt.cpu(0), mt.cpu(1)])
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1}, kvstore="device")
        x = mt.nd.array(np.ones((2, 6), np.float32))
        with mt.autograd.record():
            loss = net(x).sum()
        loss.backward()
        grads = [p.grad()._data for p in net.collect_params().values()]
        before = mt.profiler.counters()
        trainer.step(2)
        after = mt.profiler.counters()
    moved = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("kvstore_bucket_reduce", "kvstore_pull",
                       "kvstore_push")}
    assert moved == dict(kvstore_bucket_reduce=0, kvstore_pull=0,
                         kvstore_push=0)
    assert all(p.grad()._data is g
               for p, g in zip(net.collect_params().values(), grads))
    assert trainer._kvstore.type == "device"


def test_trainer_kvstore_spec_types():
    """None, a name or a KVStore; anything else raises at once."""
    with mt.cpu():
        net = mt.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        for kv in (None, "device", "local", mt.kv.create("local")):
            mt.gluon.Trainer(net.collect_params(), "sgd", kvstore=kv)
        with pytest.raises(TypeError):
            mt.gluon.Trainer(net.collect_params(), "sgd", kvstore=object())
