"""Random draws and Dropout of the PyTorch package on the CPU.

The two packages' generators differ (torch's Philox and CPU streams
against JAX's threefry), so draws are held by their statistics, not draw
for draw: every random op's sample mean and variance over 2 x 10^5 draws
lie within ``K_SE`` (5) standard errors of its distribution's own
(``test_utils.random_cases``), and its dtype is the JAX package's.
Dropout: the kept fraction within 5 standard deviations of 1 - p, the
kept values scaled by exactly 1 / (1 - p), the identity at inference and
at p 0, ``mode="always"`` at inference, a mask shared along ``axes``, the
gradient's zeros where the output's are, and in bf16 the output equal to
``x * (mask / keep)`` bit for bit.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.registry import get_op
from mxnet_tpu_torch.test_utils import random_cases, moment_errors

K_SE = 5.0
N = 200000
CASES = random_cases()


@pytest.fixture(autouse=True)
def own_names():
    """Symbols and blocks made here take their names from name managers
    of their own: the processes' global counters, which a later test may
    read (auto-named nodes of a traced net), stay as they were."""
    with mx.name.NameManager(), mt.name.NameManager():
        yield


@pytest.mark.parametrize("name,draw,mean,var", CASES,
                         ids=[c[0] for c in CASES])
def test_random_op_moments(name, draw, mean, var):
    mt.random.seed(11)
    got = draw(mt.nd, N, mt.cpu())
    err_mean, err_var = moment_errors(got.asnumpy(), mean, var)
    assert err_mean < K_SE and err_var < K_SE, (err_mean, err_var)
    with mx.cpu():
        want = draw(mx.nd, 64, mx.cpu())
    assert got.dtype == want.dtype
    assert got.shape[:-1] == want.shape[:-1]


@pytest.mark.parametrize("dtype", ["float64", "float16", "bfloat16"])
def test_random_dtype_attr(dtype):
    mt.random.seed(0)
    with mt.cpu():
        for fn in (mt.nd.random.uniform, mt.nd.random.normal,
                   mt.nd.random.gamma, mt.nd.random.exponential,
                   mt.nd.random.poisson):
            x = fn(shape=(1000,), dtype=dtype)
            assert x._data.dtype == mt.base.torch_dtype(dtype)
            assert np.isfinite(x.astype("float32").asnumpy()).all()
        ints = mt.nd.random.randint(0, 10, shape=(1000,), dtype="int64")
        assert ints._data.dtype == torch.int64
        assert 0 <= ints.asnumpy().min() and ints.asnumpy().max() < 10


def test_shuffle_is_a_permutation_of_rows():
    mt.random.seed(1)
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    with mt.cpu():
        out = mt.nd.random.shuffle(mt.nd.array(x)).asnumpy()
    assert not np.array_equal(out, x)
    np.testing.assert_array_equal(np.sort(out[:, 0]), x[:, 0])
    np.testing.assert_array_equal(out[:, 1], out[:, 0] + 1)


def test_seed_repeats_a_draw():
    """``random.seed(n)`` repeats every draw after it; torch's global
    generator plays no part."""
    def draws():
        with mt.cpu():
            return [mt.nd.random.uniform(shape=(5,)).asnumpy(),
                    mt.nd.random.normal(shape=(5,)).asnumpy(),
                    mt.nd.random.gamma(2.0, shape=(5,)).asnumpy(),
                    mt.nd.Dropout(mt.nd.ones((8,)), p=0.5,
                                  mode="always").asnumpy()]
    mt.random.seed(42)
    first = draws()
    torch.manual_seed(123)
    mt.random.seed(42)
    second = draws()
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(draws()[0], first[0])


def test_multinomial_with_log_probabilities():
    mt.random.seed(2)
    probs = np.array([[0.2, 0.8], [0.9, 0.1]], np.float32)
    with mt.cpu():
        samp, logp = mt.nd.random.multinomial(mt.nd.array(probs), shape=3,
                                              get_prob=True)
    s = samp.asnumpy().astype(int)
    assert samp.shape == (2, 3) and logp.shape == (2, 3)
    np.testing.assert_allclose(logp.asnumpy(),
                               np.log(probs[np.arange(2)[:, None], s]),
                               rtol=1e-6)


def test_symbol_random_draws_on_the_bound_device():
    mt.random.seed(3)
    s = mt.sym.random.normal(1.0, 2.0, shape=(4000,))
    assert s.infer_shape() == ([], [(4000,)], [])
    out = s.simple_bind(mt.cpu()).forward()[0]
    assert out.context == mt.cpu()
    err_mean, err_var = moment_errors(out.asnumpy(), 1.0, 4.0)
    assert err_mean < K_SE and err_var < K_SE


def _dropout(x, train=True, **kw):
    with mt.cpu():
        a = mt.nd.array(x)
        a.attach_grad()
        with mt.autograd.record(train_mode=train):
            out = mt.nd.Dropout(a, **kw)
        out.backward(mt.nd.ones(out.shape))
    return out.asnumpy(), a.grad.asnumpy()


@pytest.mark.parametrize("p", [0.1, 0.5, 0.8])
def test_dropout_statistics(p):
    mt.random.seed(4)
    n = 100000
    out, grad = _dropout(np.ones((n,), np.float32), p=p)
    keep = 1.0 - p
    kept = out != 0
    sigma = np.sqrt(keep * (1 - keep) / n)
    assert abs(kept.mean() - keep) < 5 * sigma
    np.testing.assert_array_equal(out[kept], np.float32(1.0) / np.float32(
        keep))
    # the gradient's zeros are the output's
    np.testing.assert_array_equal(grad == 0, ~kept)
    np.testing.assert_array_equal(grad, out)


def test_dropout_identity_at_inference_and_p0():
    x = np.random.RandomState(0).randn(6, 7).astype(np.float32)
    out, grad = _dropout(x, train=False, p=0.5)
    np.testing.assert_array_equal(out, x)
    np.testing.assert_array_equal(grad, 1.0)
    out, grad = _dropout(x, train=True, p=0.0)
    np.testing.assert_array_equal(out, x)


def test_dropout_always_mode_at_inference():
    mt.random.seed(5)
    out, _ = _dropout(np.ones((2000,), np.float32), train=False, p=0.5,
                      mode="always")
    assert 0.4 < (out == 0).mean() < 0.6


@pytest.mark.parametrize("op,attrs", [
    ("Dropout", {"p": 0.5}),
    ("LeakyReLU", {"act_type": "rrelu"})])
def test_draw_in_training_without_generator_raises(op, attrs):
    """A draw in training without the caller's generator is a wiring
    fault: it raises instead of passing the data through."""
    x = torch.ones(4, 5)
    with pytest.raises(MXNetError, match="no generator"):
        get_op(op).apply([x], attrs, train_mode=True, rng=None)
    # at inference nothing draws, and no generator is needed
    assert get_op(op).apply([x], attrs, train_mode=False)[0].shape == x.shape


def test_dropout_always_infers_shape():
    """Shape inference runs a ``mode="always"`` Dropout on meta tensors."""
    d = mt.sym.Dropout(mt.sym.Variable("data"), p=0.5, mode="always")
    _, out, _ = d.infer_shape(data=(3, 7))
    assert out == [(3, 7)]


def test_dropout_axes_share_the_mask():
    mt.random.seed(6)
    out, grad = _dropout(np.ones((8, 50, 6), np.float32), p=0.5, axes=(1,))
    mask = out != 0
    assert (mask == mask[:, :1, :]).all()
    assert 0 < mask.mean() < 1
    np.testing.assert_array_equal(grad == 0, ~mask)


def test_dropout_bf16_is_x_times_scaled_mask():
    """The mask is cast to bf16 and divided by keep in bf16, then
    multiplied: equal to ``x * (mask / keep)`` in bf16 bit for bit."""
    mt.random.seed(7)
    p = 0.3
    x = torch.randn(4096).to(torch.bfloat16)
    gen = mt.random.generator(mt.cpu())
    state = gen.get_state()
    with mt.cpu():
        out = mt.nd.Dropout(mt.nd.NDArray(x.clone(), mt.cpu()), p=p,
                            mode="always")._data
    gen.set_state(state)
    mask = (torch.rand(x.shape, generator=gen) < 1 - p).to(torch.bfloat16)
    assert torch.equal(out, x * (mask / (1 - p)))


def test_dropout_layer_in_a_hybridized_net():
    """``nn.Dropout`` inside a hybridized block (its cached graph, run
    eagerly on the CPU): a fresh mask each recorded call, the identity
    outside training."""
    mt.random.seed(8)
    with mt.cpu():
        net = mt.gluon.nn.HybridSequential()
        net.add(mt.gluon.nn.Dropout(0.5))
        net.initialize()
        net.hybridize()
        x = mt.nd.ones((4, 256))
        with mt.autograd.record():
            a = net(x).asnumpy()
        with mt.autograd.record():
            b = net(x).asnumpy()
        c = net(x).asnumpy()
    assert not np.array_equal(a, b)
    assert set(np.unique(a)) <= {0.0, 2.0}
    np.testing.assert_array_equal(c, 1.0)


def test_module_with_dropout_scores_as_the_identity():
    """``Module``'s training step draws (``CachedTrainStep``), and its
    ``predict`` takes Dropout as the identity."""
    mt.random.seed(9)
    with mt.cpu():
        data = mt.sym.Variable("data")
        net = mt.sym.FullyConnected(data, num_hidden=4, name="fc")
        net = mt.sym.Dropout(net, p=0.5)
        net = mt.sym.SoftmaxOutput(net, mt.sym.Variable("softmax_label"),
                                   name="softmax")
        mod = mt.mod.Module(net, context=mt.cpu())
        x = np.random.RandomState(1).randn(16, 8).astype(np.float32)
        y = np.arange(16, dtype=np.float32) % 4
        it = mt.io.NDArrayIter(x, y, batch_size=16)
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label)
        mod.init_params(initializer=mt.initializer.Xavier())
        mod.init_optimizer(optimizer_params=(("learning_rate", 0.1),))
        batch = next(iter(it))
        mod._fit_step(batch)
        assert mod._cached_step is not None and mod._cached_step._draws
        p1 = mod.predict(it).asnumpy()
        p2 = mod.predict(it).asnumpy()
        np.testing.assert_array_equal(p1, p2)
        arg, _ = mod.get_params()
        w, b = arg["fc_weight"].asnumpy(), arg["fc_bias"].asnumpy()
        z = x @ w.T + b
        e = np.exp(z - z.max(axis=1, keepdims=True))
        np.testing.assert_allclose(p1, e / e.sum(axis=1, keepdims=True),
                                   rtol=1e-5, atol=1e-6)
