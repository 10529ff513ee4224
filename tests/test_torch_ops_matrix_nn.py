"""The op sweep of ``mxnet_tpu_torch.test_utils.op_cases`` for the matrix
and nn ops (``test_torch_ops_breadth.py`` has the elemwise and reduce
ops, and the mirrored reference cases): the same seeded inputs through
``mxnet_tpu`` and ``mxnet_tpu_torch`` on the CPU, forward and gradients
under a seeded head gradient, each case at the tolerance stated beside it
in ``op_cases`` (``FP32_TOL``, 1e-5 relative, unless the case says why it
needs more); ``dot`` and ``batch_dot`` again in bf16 (``BF16_TOL``, 2^-6
relative)."""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.registry import OP_REGISTRY
from mxnet_tpu_torch.test_utils import op_cases, run_op_case, BF16_TOL


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    """The JAX package turns x64 on at import; another test may have
    turned it off in this worker.  Two torch threads: the suite runs
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


CASES = [c for c in op_cases() if OP_REGISTRY[c["op"]].fn.__module__
         .rsplit(".", 1)[-1] in ("matrix", "nn")]


def check_case(case, dtype):
    tol = case["tol"] if dtype == "float32" else BF16_TOL
    with mx.cpu():
        want = run_op_case(mx, case, mx.cpu(), dtype)
    got = run_op_case(mt, case, mt.cpu(), dtype)
    assert len(got[0]) == len(want[0])
    for k, (g, w) in enumerate(zip(got[0] + got[1], want[0] + want[1])):
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg="%s item %d"
                                   % (case["name"], k), **tol)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_op_sweep(case):
    check_case(case, "float32")


BF16_CASES = [c for c in CASES if c["bf16"]]


@pytest.mark.parametrize("case", BF16_CASES,
                         ids=[c["name"] for c in BF16_CASES])
def test_op_sweep_bf16(case):
    check_case(case, "bfloat16")


def test_creation_ops_follow_the_context():
    """``nd.arange``/``nd.eye`` and the ``_zeros``-style ops make their
    output on the context asked for, and raise without a card when that
    is the default."""
    with mt.cpu():
        assert mt.nd.arange(0, 3).context == mt.cpu()
        assert mt.nd.eye(2, ctx=mt.cpu()).context == mt.cpu()
    np.testing.assert_array_equal(
        mt.nd.arange(1, 7, 2, repeat=2, ctx=mt.cpu()).asnumpy(),
        mx.nd.arange(1, 7, 2, repeat=2, ctx=mx.cpu()).asnumpy())
    np.testing.assert_array_equal(
        mt.nd.eye(3, 4, k=-1, ctx=mt.cpu()).asnumpy(),
        mx.nd.eye(3, 4, k=-1, ctx=mx.cpu()).asnumpy())
    if not torch.cuda.is_available():
        with pytest.raises(mt.MXNetError):
            mt.nd.arange(0, 3)


@pytest.mark.parametrize("dtype", ["float64", "float32", "float16",
                                   "bfloat16", "int32"])
def test_arange_follows_numpy_bit_for_bit(dtype):
    """``_arange`` builds on the op's device by ``np.arange``'s length and
    fill rules, which ``jnp.arange`` takes where a step is given: equal
    bit for bit over float steps that are not exact in binary, negative
    steps, empty ranges and ``stop`` None (exact equality)."""
    import ml_dtypes
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    arange = OP_REGISTRY["_arange"].fn
    rng = np.random.RandomState(0)
    cases = [(0.5, 3.2, 0.3), (5, None, 1.0), (-1, 1, 0.01),
             (10, 0, -0.7), (3, 1, 1), (1, 1, 1)]
    for _ in range(100):
        start = rng.uniform(-50, 50)
        step = rng.choice([-1, 1]) * rng.uniform(0.001, 3)
        cases.append((start, start + step * rng.uniform(-2, 300), step))
    for start, stop, step in cases:
        want = np.arange(start, stop, step, dtype=np_dtype)
        got = arange(start=start, stop=stop, step=step, dtype=dtype,
                     ctx=torch.device("cpu"))
        assert got.dtype == mt.base.torch_dtype(dtype)
        np.testing.assert_array_equal(got.to(torch.float64).numpy(),
                                      want.astype(np.float64),
                                      err_msg=str((start, stop, step)))


def test_ndarray_surface():
    """The fluent methods, ``.T``, ``@``, iteration and the ``nd`` helpers
    against the JAX package's."""
    x = np.random.RandomState(3).randn(3, 4).astype(np.float32)

    def run(pkg):
        a = pkg.nd.array(x)
        outs = [a.T, a @ a.T, a.max(axis=1), a.min(), a.prod(axis=0),
                a.argmax(axis=1), a.argmin(), a.clip(-0.5, 0.5), a.abs(),
                a.sign(), a.square(), a.exp(), a.sigmoid(), a.tanh(),
                a.softmax(), a.log_softmax(axis=0), a.transpose((1, 0)),
                a.expand_dims(1), a.swapaxes(0, 1), a.flip(1),
                a.tile((2, 1)), a.repeat(2, axis=0), a.norm(),
                a.sort(), a.argsort(is_ascend=False),
                a.topk(k=2, ret_typ="value")[0], a.nansum(axis=1),
                a.nanprod(), a.slice((0, 1), (2, 3)),
                a.slice_axis(1, 1, 3), a.broadcast_to((2, 3, 4)),
                a.split(2, axis=1)[1], a.reshape_like(a.T),
                a.one_hot(5).sum(), a.take(pkg.nd.array([0, 2])),
                a.pick(pkg.nd.array([0, 1, 3]), axis=1),
                a.reshape((1, 1, 3, 4)).pad("edge", (0, 0, 0, 0, 1, 1, 2,
                                                     2)),
                pkg.nd.moveaxis(a.expand_dims(2), 2, 0),
                pkg.nd.ones_like(a), pkg.nd.zeros_like(a), a.dot(a.T)]
        outs += list(a)
        oh = pkg.nd.zeros((3, 5))
        pkg.nd.onehot_encode(pkg.nd.array([1, 0, 4]), oh)
        outs.append(oh)
        a.wait_to_read()
        pkg.nd.waitall()
        return [o.astype("float64").asnumpy() for o in outs]
    with mx.cpu():
        theirs = run(mx)
    with mt.cpu():
        ours = run(mt)
    assert len(ours) == len(theirs)
    for i, (g, w) in enumerate(zip(ours, theirs)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   err_msg="item %d" % i)
