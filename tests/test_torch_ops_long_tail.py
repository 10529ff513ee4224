"""The op sweep of ``mxnet_tpu_torch.test_utils.op_cases`` for the ssd and
rcnn ops (``test_torch_ops_contrib.py`` has the contrib ops,
``test_torch_ops_breadth.py`` the elemwise and reduce ops,
``test_torch_ops_matrix_nn.py`` the matrix and nn ops, the spatial and
linalg ones among them): the same seeded inputs through
``mxnet_tpu`` and ``mxnet_tpu_torch`` on the CPU, forward and gradients
under a seeded head gradient, each case at the tolerance stated beside it
in ``op_cases`` (``FP32_TOL``, 1e-5 relative, unless the case says why it
needs more).  The same cases run card against CPU in ``chip_smoke.py``'s
phase 21."""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.registry import OP_REGISTRY
from mxnet_tpu_torch.test_utils import op_cases, run_op_case

SWEEP_MODULES = ("ssd", "rcnn")
# the modules of the long tail, whose every op must have a case
LONG_TAIL_MODULES = ("ssd", "rcnn", "contrib")


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    prev = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_enable_x64", prev[0])
    torch.set_num_threads(prev[1])


def _module(case):
    return OP_REGISTRY[case["op"]].fn.__module__.rsplit(".", 1)[-1]


CASES = [c for c in op_cases() if _module(c) in SWEEP_MODULES]


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_op_sweep(case):
    with mx.cpu():
        want = run_op_case(mx, case, mx.cpu())
    got = run_op_case(mt, case, mt.cpu())
    assert len(got[0]) == len(want[0])
    for k, (g, w) in enumerate(zip(got[0] + got[1], want[0] + want[1])):
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg="%s item %d"
                                   % (case["name"], k), **case["tol"])


def test_sweep_covers_the_long_tail_modules():
    """Every distinct op of the ssd, rcnn and contrib modules has a case in
    the sweep (``test_torch_ops_breadth.py`` checks the other four)."""
    covered = {id(OP_REGISTRY[c["op"]]) for c in op_cases()}
    missing = sorted(n for n, op in OP_REGISTRY.items()
                     if op.fn.__module__.rsplit(".", 1)[-1]
                     in LONG_TAIL_MODULES and id(op) not in covered)
    assert not missing


def test_phase_tool_imports_no_jax():
    """``tools/torch_ssd_chip.py`` (phase 31 alone, on the card) imports
    neither JAX nor the JAX package."""
    import ast
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "tools", "torch_ssd_chip.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names] + [n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom) and n.module]
    assert not {n.split(".")[0] for n in names} & {"jax", "jaxlib",
                                                   "mxnet_tpu"}
