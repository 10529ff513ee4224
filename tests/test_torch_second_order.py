"""``autograd.grad`` and ``autograd.get_symbol`` of the PyTorch package
against the JAX package, and second-order gradients through the port's
three autograd Functions that launch kernels or replay graphs on the
card: a hybridized block's captured call (``gluon.block._Replayed``),
``dot`` of a CSR (``ops.sparse_dot._CSRDot``) and ``FlashAttention``.

Mirrors ``tests/test_autograd.py:79-184``.  On the CPU the port's
captured programs are driven by a stand-in graph (``capture.stand_in``:
its capture runs the step once, its replay runs it again), so the
hybridized block goes through ``_Replayed`` here as it does on the card.

What the JAX package does:

- ``grad(create_graph=True)`` differentiates again only through the
  variables given to ``grad`` (``mxnet_tpu/autograd.py:301-323``): a
  parameter reached only through the first-order gradient gets no
  second-order term there.  The variables' gradients are held to it
  (fp32, rtol 1e-5); the parameters' to the port's own eager block and
  to central differences in fp64 (rtol 1e-6);
- through a hybridized block it raises ``AttributeError`` (its cached
  op's tape node has no op to replay), so the port's hybridized block is
  held to the JAX package's block run eagerly;
- through ``dot`` of a CSR it gives the values (fp32, rtol 1e-5);
- through ``flash_attention`` it raises (``pallas_call`` has no JVP
  rule); the port raises ``MXNetError``.
"""
import weakref

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import capture, profiler

PKGS = {"jax": mx, "torch": mt}
RTOL = 1e-5


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


def _arr(pkg, x, dtype=np.float32):
    return pkg.nd.array(np.asarray(x, dtype), ctx=pkg.cpu(), dtype=dtype)


def test_autograd_grad_function():
    for pkg in PKGS.values():
        x = _arr(pkg, [1., 2., 3.])
        x.attach_grad()
        with pkg.autograd.record():
            y = (x * x).sum()
            g = pkg.autograd.grad(y, [x], retain_graph=True)
        np.testing.assert_allclose(g[0].asnumpy(), 2 * x.asnumpy())


def test_grad_writes_no_buffer():
    """The port's ``grad`` returns the gradients only (the JAX package's
    first-order ``grad`` also writes the marked buffers,
    ``_finalize_marked``; ROADMAP "Not faults")."""
    x = _arr(mt, [1., 2., 3.])
    x.attach_grad("add")
    with mt.autograd.record():
        y = (x * x * x).sum()
    (g,) = mt.autograd.grad(y, [x])
    np.testing.assert_array_equal(g.asnumpy(), [3., 12., 27.])
    np.testing.assert_array_equal(x.grad.asnumpy(), [0., 0., 0.])


def test_grad_of_an_unrecorded_variable_raises():
    x, z = _arr(mt, [1., 2.]), _arr(mt, [3., 4.])
    x.attach_grad()
    z.attach_grad()
    with mt.autograd.record():
        y = (x * 2.0).sum()
    with pytest.raises(mt.MXNetError):
        mt.autograd.grad(y, [z])
    with pytest.raises(mt.MXNetError):
        mt.autograd.grad(_arr(mt, [1.0]), [x])


CREATE_GRAPH_CASES = {
    # d2/dx2 x^3 = 6x
    "second_order": (lambda x, g: g.sum(), lambda x: x * x * x,
                     [1.0, 2.0, 3.0]),
    # d/dx [(dy/dx) x] with y = x^2 -> 4x
    "mixed_expression": (lambda x, g: (g * x).sum(), lambda x: x * x,
                         [0.5, -1.5]),
}


@pytest.mark.parametrize("case", sorted(CREATE_GRAPH_CASES))
def test_grad_create_graph(case):
    outer, inner, values = CREATE_GRAPH_CASES[case]
    got = {}
    for key, pkg in PKGS.items():
        x = _arr(pkg, values)
        x.attach_grad()
        with pkg.autograd.record():
            y = inner(x)
            (g,) = pkg.autograd.grad(y, [x], create_graph=True)
            z = outer(x, g)
        z.backward()
        got[key] = (g.asnumpy(), x.grad.asnumpy())
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=RTOL)
    np.testing.assert_allclose(got["torch"][1], got["jax"][1], rtol=RTOL)
    want = {"second_order": 6.0, "mixed_expression": 4.0}[case]
    np.testing.assert_allclose(got["torch"][1], want * np.asarray(values),
                               rtol=RTOL)


def _recorded(pkg, part=0):
    x = _arr(pkg, np.arange(6).reshape(2, 3))
    w = _arr(pkg, np.ones((4, 3)))
    x.attach_grad()
    with pkg.autograd.record():
        h = pkg.nd.FullyConnected(x, w, num_hidden=4, no_bias=True)
        y = pkg.nd.Activation(h * 0.5 + 1.0, act_type="tanh")
        parts = pkg.nd.split(y, num_outputs=2, axis=1)
        out = parts[part].sum(axis=1)
    return x, w, out


def test_get_symbol_equals_reference():
    texts = {}
    for key, pkg in PKGS.items():
        with pkg.name.NameManager():
            _, _, out = _recorded(pkg)
            texts[key] = pkg.autograd.get_symbol(out).debug_str()
    assert texts["torch"] == texts["jax"]
    assert "Op:SliceChannel" in texts["torch"]
    assert "Variable:var0" in texts["torch"]


def test_get_symbol_of_a_later_output():
    """The second output of a multi-output op: the port picks it by
    identity (the JAX package compares arrays with ``==`` there and
    raises ``ValueError``; ROADMAP "Not faults")."""
    with mt.name.NameManager():
        _, _, out = _recorded(mt, part=1)
        s = mt.autograd.get_symbol(out)
    assert s.get_children().list_outputs() == ["slicechannel0_output1"]
    with mx.name.NameManager():
        _, _, ref = _recorded(mx, part=1)
        with pytest.raises(ValueError):
            mx.autograd.get_symbol(ref)


@pytest.mark.parametrize("part", [0, 1])
def test_get_symbol_binds_to_the_recorded_outputs(part):
    x, w, out = _recorded(mt, part)
    s = mt.autograd.get_symbol(out)
    args = s.list_arguments()
    exe = s.bind(mt.cpu(), {args[0]: x.detach(), args[1]: w})
    np.testing.assert_array_equal(exe.forward()[0].asnumpy(), out.asnumpy())


def test_get_symbol_needs_a_recorded_output():
    a = _arr(mt, [1.0, 2.0])
    b = a * 2.0   # not recorded: nothing is kept
    assert b._node is None
    with pytest.raises(mt.MXNetError):
        mt.autograd.get_symbol(b)


def test_recorded_outputs_keep_no_intermediate_array():
    """What ``get_symbol`` reads keeps no array that a recorded op made:
    an intermediate is freed once nothing else holds it, and the graph
    is rebuilt all the same."""
    x = _arr(mt, np.arange(6.0).reshape(2, 3))
    x.attach_grad()
    with mt.autograd.record():
        h = x * 2.0
        out = (h + 1.0).sum()
    held = weakref.ref(h), weakref.ref(h._data)
    del h
    out.backward()
    assert held[0]() is None and held[1]() is None
    with mt.name.NameManager():
        s = mt.autograd.get_symbol(out)
    assert s.get_internals().list_outputs() == [
        "var0", "mulscalar0_output", "plusscalar0_output", "sum0_output"]


# -- repair: a hybridized block under create_graph ------------------------
def _dense_stack(pkg, seed=3):
    pkg.random.seed(seed)
    net = pkg.gluon.nn.HybridSequential(prefix="gp_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(6, activation="tanh", in_units=3),
                pkg.gluon.nn.Dense(1, in_units=6))
    net.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
    return net


def gradient_penalty(pkg, net, x):
    """WGAN-GP's penalty: sum over rows of (|d net(x) / dx| - 1)^2, and
    its gradients (x's, then each parameter's)."""
    x.attach_grad()
    with pkg.autograd.record():
        y = net(x)
        (gx,) = pkg.autograd.grad(y, [x], create_graph=True)
        norm = (gx * gx).sum(axis=1).sqrt()
        pen = ((norm - 1.0) ** 2).sum()
    pen.backward()
    params = [p.grad().asnumpy() for p in net.collect_params().values()]
    return pen.asnumpy(), x.grad.asnumpy(), params


def _penalty_input(dtype=np.float32):
    return np.random.RandomState(4).randn(5, 3).astype(dtype)


def test_hybridized_penalty_matches_eager_and_reference():
    x = _penalty_input()
    eager = gradient_penalty(mt, _dense_stack(mt), _arr(mt, x))
    net = _dense_stack(mt)
    net.hybridize()
    with capture.stand_in(StandInGraph):
        hyb = gradient_penalty(mt, net, _arr(mt, x))
    assert profiler.counter("create_graph_recomputes") == 1
    assert profiler.counter("graph_captures") >= 1
    np.testing.assert_allclose(hyb[0], eager[0], rtol=RTOL)
    np.testing.assert_allclose(hyb[1], eager[1], rtol=RTOL)
    for a, b in zip(hyb[2], eager[2]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-7)
    # every term but the last bias's, which the input gradient does not
    # depend on
    assert all(np.abs(p).max() > 0 for p in hyb[2][:-1])
    assert np.abs(hyb[2][-1]).max() == 0
    ref = gradient_penalty(mx, _dense_stack(mx), _arr(mx, x))
    np.testing.assert_allclose(hyb[0], ref[0], rtol=RTOL)
    np.testing.assert_allclose(hyb[1], ref[1], rtol=RTOL)


def _dropout_stack(seed=3):
    mt.random.seed(seed)
    net = mt.gluon.nn.HybridSequential(prefix="gpd_")
    with net.name_scope():
        net.add(mt.gluon.nn.Dense(16, activation="tanh", in_units=3),
                mt.gluon.nn.Dropout(0.5),
                mt.gluon.nn.Dense(1, in_units=16))
    net.initialize(mt.init.Xavier(), ctx=mt.cpu())
    return net


def test_hybridized_penalty_with_dropout_takes_the_replays_mask():
    """A block that draws: the recompute under ``create_graph`` draws the
    replay's mask, so the penalty and its gradients equal the block run
    eagerly from the same generator state (fp32, rtol 1e-5), and the
    generator ends where that run leaves it."""
    x = _penalty_input()
    eager_net = _dropout_stack()
    net = _dropout_stack()
    net.hybridize()
    gen = mt.random.generator(mt.cpu())
    with capture.stand_in(StandInGraph):
        with mt.autograd.record():  # captures the call's program
            loss = net(_arr(mt, x)).sum()
        loss.backward()
        net.collect_params().zero_grad()
        start = gen.get_state()
        hyb = gradient_penalty(mt, net, _arr(mt, x))
    hyb_end = gen.get_state()
    assert profiler.counter("create_graph_recomputes") == 1
    gen.set_state(start)
    eager = gradient_penalty(mt, eager_net, _arr(mt, x))
    assert torch.equal(gen.get_state(), hyb_end)
    np.testing.assert_allclose(hyb[0], eager[0], rtol=RTOL)
    np.testing.assert_allclose(hyb[1], eager[1], rtol=RTOL)
    for a, b in zip(hyb[2], eager[2]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-7)
    # the mask dropped units: some first-layer rows get no gradient
    assert (np.abs(hyb[2][0]).max(axis=1) == 0).any()


def test_reference_hybridized_penalty_raises():
    net = _dense_stack(mx)
    net.hybridize()
    with pytest.raises(AttributeError):
        gradient_penalty(mx, net, _arr(mx, _penalty_input()))


def test_hybridized_penalty_parameter_terms_match_central_differences():
    """The parameters' second-order terms (which the JAX package drops)
    against central differences of the penalty in fp64."""
    x = _penalty_input(np.float64)
    net = _dense_stack(mt)
    net.cast("float64")
    net.hybridize()
    with capture.stand_in(StandInGraph):
        pen, _, grads = gradient_penalty(mt, net, _arr(mt, x, np.float64))
    params = list(net.collect_params().values())
    eps = 1e-6
    for p, g in zip(params, grads):
        flat = p.data()._data.view(-1)
        for i in range(0, flat.numel(), max(1, flat.numel() // 4)):
            vals = []
            for step in (eps, -eps):
                with torch.no_grad():
                    flat[i] += step
                with mt.autograd.record():
                    xa = _arr(mt, x, np.float64)
                    xa.attach_grad()
                    y = net(xa)
                    (gx,) = mt.autograd.grad(y, [xa], create_graph=True)
                    norm = (gx * gx).sum(axis=1).sqrt()
                vals.append(float(((norm - 1.0) ** 2).sum().asnumpy()))
                with torch.no_grad():
                    flat[i] -= step
            fd = (vals[0] - vals[1]) / (2 * eps)
            np.testing.assert_allclose(g.reshape(-1)[i], fd, rtol=1e-6,
                                       atol=1e-9)


def test_first_order_backward_still_replays():
    net = _dense_stack(mt)
    net.hybridize()
    x = _arr(mt, _penalty_input())
    with capture.stand_in(StandInGraph):
        for _ in range(2):
            with mt.autograd.record():
                loss = net(x).sum()
            loss.backward()
    assert profiler.counter("create_graph_recomputes") == 0
    assert profiler.counter("graph_replays") >= 4


# -- repair: dot of a CSR under create_graph ------------------------------
def _csr_case(pkg, transpose_a):
    rng = np.random.RandomState(6)
    dense = (rng.randn(5, 7) * (rng.rand(5, 7) > 0.5)).astype(np.float32)
    csr = pkg.nd.array(dense, ctx=pkg.cpu()).tostype("csr")
    w = _arr(pkg, rng.randn(5 if transpose_a else 7, 3))
    w.attach_grad()
    with pkg.autograd.record():
        o = pkg.nd.dot(csr, w, transpose_a=transpose_a)
        (gw,) = pkg.autograd.grad((o * o).sum(), [w], create_graph=True)
        pen = (gw * gw).sum()
    pen.backward()
    if pkg is mt:
        # the gradient came out of the kernels' Function again (on the
        # card a kernel's output alone would carry no graph)
        fn = gw._data.grad_fn
        while type(fn).__name__.startswith(("View", "Reshape")):
            fn = fn.next_functions[0][0]
        assert type(fn).__name__ == "_CSRDotBackward"
    return gw.asnumpy(), w.grad.asnumpy()


@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot_second_order_matches_reference(transpose_a):
    got, want = _csr_case(mt, transpose_a), _csr_case(mx, transpose_a)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-5)
    assert np.abs(got[1]).max() > 0


# -- repair: flash attention under create_graph ---------------------------
def _qkv(seed=8, shape=(1, 2, 16, 16)):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def test_flash_attention_second_order_raises_as_the_reference_does():
    import jax
    from mxnet_tpu.ops import pallas_kernels as pk
    from mxnet_tpu_torch.ops import attention as att
    q, k, v = _qkv()

    def loss(q, k, v):
        return (pk.flash_attention(q, k, v, interpret=True) ** 2).sum()

    def penalty(q, k, v):
        gs = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
        return sum((g * g).sum() for g in gs)
    with pytest.raises(AssertionError):   # pallas_call's JVP rule
        jax.grad(penalty)(q, k, v)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = att.flash_attention(qt, kt, vt)
    (gq,) = torch.autograd.grad((out ** 2).sum(), [qt])
    np.testing.assert_allclose(gq.numpy(), np.asarray(jax.grad(loss)(q, k, v)),
                               rtol=1e-4, atol=1e-5)
    out = att.flash_attention(qt, kt, vt)
    with pytest.raises(mt.MXNetError):
        torch.autograd.grad((out ** 2).sum(), [qt], create_graph=True)
