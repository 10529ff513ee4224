"""BASELINE #5, ``examples/train_ssd_toy.py``'s ``ToySSD``, against the JAX
package on the CPU.

The net is ``chip_smoke.toy_ssd_net`` in either package, trained by
``chip_smoke.toy_ssd_train`` (the example's loop: ``MultiBoxTarget``
under ``record()``, ``SoftmaxCrossEntropyLoss`` plus ``HuberLoss``,
``Trainer("adam")``) on the example's own ``synthetic_detection_set``.

- The JAX package's weights carried across in its ``.params`` file: 3
  Adam steps at batch 4 in fp64 (the JAX package's Trainer through its
  per-parameter loop: its fused step rounds lr and wd to fp32),
  ``MultiBoxTarget``'s outputs equal and the losses and the weights
  within 1e-9 (the same fp64 operations in other summation orders).
- Hybridized under a stand-in graph: the block (backbone, heads and
  ``MultiBoxPrior``) is one program, replayed a step with the backward
  and the fused update, the losses the eager net's bit for bit.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import capture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_TOL = 1e-9


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load("chip_smoke_for_ssd_tests", "chip_smoke.py")


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    prev = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_enable_x64", prev[0])
    torch.set_num_threads(prev[1])


@pytest.fixture(autouse=True)
def own_names():
    with mx.name.NameManager(), mt.name.NameManager():
        yield


@pytest.fixture
def jax_loop_trainer():
    """The JAX package's Trainer through its per-parameter loop: its fused
    step rounds lr and wd to fp32 (ROADMAP "Not faults")."""
    from mxnet_tpu.gluon import fused_trainer as jax_fused
    prev = os.environ.get("MXNET_FUSED_TRAINER")
    os.environ["MXNET_FUSED_TRAINER"] = "0"
    jax_fused.refresh_from_env()
    yield
    if prev is None:
        os.environ.pop("MXNET_FUSED_TRAINER", None)
    else:
        os.environ["MXNET_FUSED_TRAINER"] = prev
    jax_fused.refresh_from_env()


def test_toy_ssd_three_adam_steps_fp64_against_jax(tmp_path,
                                                    jax_loop_trainer):
    init = chip_smoke.toy_ssd_net(mx)
    mx.random.seed(0)
    init.collect_params().initialize(mx.init.Xavier(), ctx=mx.cpu())
    init(mx.nd.zeros((1, 1, 32, 32)))
    path = str(tmp_path / "toyssd.params")
    init.save_params(path)
    with mx.cpu():
        want = chip_smoke.toy_ssd_train(mx, mx.cpu(), dtype="float64",
                                        steps=3, batch=4, params_file=path)
    with mt.cpu():
        got = chip_smoke.toy_ssd_train(mt, mt.cpu(), dtype="float64",
                                       steps=3, batch=4, params_file=path)
    for tw, tg in zip(want["targets"], got["targets"]):
        for w, g in zip(tw, tg):
            np.testing.assert_array_equal(g, w)
    for w, g in zip(want["step_losses"], got["step_losses"]):
        np.testing.assert_allclose(g, w, rtol=TOY_TOL, atol=TOY_TOL)
    assert got["step_losses"][-1].mean() < got["step_losses"][0].mean()
    pw = {n: p.data().asnumpy() for n, p in
          want["net"].collect_params().items()}
    for n, p in got["net"].collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(), pw[n], rtol=TOY_TOL,
                                   atol=TOY_TOL, err_msg=n)


class _StandIn:
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


def test_hybridized_toy_ssd_replays_its_forward():
    """Hybridized, the block (backbone, heads and ``MultiBoxPrior``) is one
    program: a step replays the forward, the backward and the fused
    update, and captures nothing after the first; the losses are the
    eager net's bit for bit."""
    torch.set_num_threads(1)
    try:
        with mt.cpu():
            eager = chip_smoke.toy_ssd_train(mt, mt.cpu(), steps=3)
            with capture.stand_in(_StandIn):
                hyb = chip_smoke.toy_ssd_train(mt, mt.cpu(), hybridize=True,
                                               steps=3)
    finally:
        torch.set_num_threads(2)
    want = dict(graph_captures=0, graph_replays=3, program_calls=3)
    assert hyb["step_counts"][0]["graph_captures"] == 3
    assert hyb["step_counts"][1:] == [want, want]
    for a, b in zip(eager["step_losses"], hyb["step_losses"]):
        np.testing.assert_array_equal(a, b)
