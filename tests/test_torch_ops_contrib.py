"""The op sweep of ``mxnet_tpu_torch.test_utils.op_cases`` for the contrib
ops (CTC, quantize, dequantize, fft, ifft, count sketch): the same seeded
inputs through ``mxnet_tpu`` and ``mxnet_tpu_torch`` on the CPU, forward
and gradients under a seeded head gradient, each case at the tolerance
stated beside it in ``op_cases`` (``FP32_TOL``, 1e-5 relative).  The CTC
cases cover both blank conventions, the length inputs and an alignment
that cannot fit (a loss of about 1e30 in both packages, its
gradient left out: rounding noise).  ``test_torch_ops_long_tail.py``
has the ssd and rcnn ops."""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.registry import OP_REGISTRY
from mxnet_tpu_torch.test_utils import op_cases, run_op_case


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    prev = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_enable_x64", prev[0])
    torch.set_num_threads(prev[1])


CASES = [c for c in op_cases()
         if OP_REGISTRY[c["op"]].fn.__module__.endswith(".contrib")]


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
