"""LM train steps of the PyTorch package against the JAX package.

The JAX package's steps run on a one-device mesh (on the CPU its attention
is the exact jnp ``local_attention``, differentiated by JAX); the port's
run on the CPU through its ``FlashAttention`` Function, whose backward is
the plain ``chunked_attention_grads``.  Both start from the JAX package's
params (``params_from_jax``) and take the same numpy batch.  Also here:
the ZeRO-1 rule and state arithmetic of ``parallel.zero`` against the JAX
module's, and the tests of ``tests/test_models.py`` that hold at one
device.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.models import transformer as jt
from mxnet_tpu.parallel import zero as jzero
from mxnet_tpu.parallel.mesh import make_mesh

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.parallel import zero as tzero

SMALL = dict(vocab=32, d_model=16, n_heads=4, d_ff=32, n_layers=2,
             max_len=16)
STEPS = 3
JAX_DTYPE = {"float32": jnp.float32, "float64": jnp.float64,
             "bfloat16": jnp.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64,
               "bfloat16": torch.bfloat16}
# Largest |port - JAX| after each of 3 steps at lr 0.1 (momentum 0.9).
# fp32: sums in other orders; the params (|p| up to about 1.1) and momenta
# differ by an fp32 ulp or two (1.2e-7 and 1.5e-7 measured on the CPU),
# the fp32 loss by one ulp (2.4e-7): limits about 8 times that.
# fp64: the loss is fp32 in both packages (the logits are widened to fp32
# only); the port's attention computes in fp32 (its plain versions, like
# its kernels, widen to fp32 and no further) where the JAX package's
# local_attention stays in fp64, so params and momenta part by about 2e-8
# (measured) after 3 steps: limit 1e-7.
# bf16: every activation and update rounds to bf16 at places that differ
# between the two frameworks; params differ by one bf16 ulp at |p| in
# [1, 2) (2^-7, measured): limit two ulps of the largest |p|; a momentum
# adds three steps' gradients, each off by an ulp or so: four ulps of the
# largest |m|; the loss 1.0e-3 (measured): limit 4e-3.
TOL = {
    "float32": dict(loss=2e-6, params=1e-6, momenta=1e-6),
    "float64": dict(loss=2e-6, params=1e-7, momenta=1e-7),
    "bfloat16": dict(loss=4e-3, params=2.0 ** -6, momenta=2.0 ** -5),
}


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


def _mesh():
    return make_mesh({"data": 1, "seq": 1, "model": 1}, jax.devices()[:1])


def _batch(b=4, s=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, SMALL["vocab"], (b, s)).astype(np.int32),
            rng.randint(0, SMALL["vocab"], (b, s)).astype(np.int32))


def _host(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype.name == "bfloat16" else a


def _setup(dtype):
    jcfg = jt.TransformerLMConfig(dtype=JAX_DTYPE[dtype], **SMALL)
    tcfg = tt.TransformerLMConfig(dtype=TORCH_DTYPE[dtype], **SMALL)
    mesh = _mesh()
    jparams = jt.init_transformer_params(jax.random.PRNGKey(0), jcfg, mesh)
    tparams = tt.params_from_jax({n: _host(a) for n, a in jparams.items()},
                                 tcfg, device="cpu")
    tokens, labels = _batch()
    return (jcfg, tcfg, mesh, jparams, tparams,
            jt.place_batch(tokens, labels, mesh),
            tt.place_batch(tokens, labels, device="cpu"))


def _largest(jd, td):
    """Largest |JAX - port| over a dict of tensors, and largest |JAX|."""
    diff = max(float(np.abs(_host(jd[n]).astype(np.float64)
                            - td[n].double().numpy()).max()) for n in td)
    return diff, max(float(np.abs(_host(jd[n])).max()) for n in td)


def _limit(dtype, key, largest):
    tol = TOL[dtype][key]
    # bf16 limits are in units of the largest value
    return tol * largest if dtype == "bfloat16" and key != "loss" else tol


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_train_step_matches_jax(dtype):
    jcfg, tcfg, mesh, jp, tp, (jtok, jlab), (ttok, tlab) = _setup(dtype)
    jstep = jt.make_train_step(jcfg, mesh, lr=0.1)
    tstep = tt.make_train_step(tcfg, lr=0.1, device="cpu")
    for i in range(STEPS):
        jp, jloss = jstep(jp, jtok, jlab)
        tp, tloss = tstep(tp, ttok, tlab)
        assert tloss.dtype == torch.float32
        assert abs(float(jloss) - float(tloss)) <= TOL[dtype]["loss"], i
        diff, largest = _largest(jp, tp)
        assert diff <= _limit(dtype, "params", largest), (i, diff)
    assert all(t.dtype == tcfg.dtype for t in tp.values())


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_zero1_step_matches_jax(dtype):
    jcfg, tcfg, mesh, jp, tp, (jtok, jlab), (ttok, tlab) = _setup(dtype)
    jstep, jm = jt.make_train_step_zero1(jcfg, mesh, jp, lr=0.1,
                                         momentum=0.9)
    tstep, tm = tt.make_train_step_zero1(tcfg, tp, lr=0.1, momentum=0.9)
    assert set(tm) == set(tp)
    assert all(float(m.abs().max()) == 0 and m.dtype == tcfg.dtype
               for m in tm.values())
    for i in range(STEPS):
        jp, jm, jloss = jstep(jp, jm, jtok, jlab)
        tp, tm, tloss = tstep(tp, tm, ttok, tlab)
        assert abs(float(jloss) - float(tloss)) <= TOL[dtype]["loss"], i
        diff, largest = _largest(jp, tp)
        assert diff <= _limit(dtype, "params", largest), (i, diff)
        diff, largest = _largest(jm, tm)
        assert largest > 0
        assert diff <= _limit(dtype, "momenta", largest), (i, diff)


def test_zero1_step_matches_plain_sgd():
    """``tests/test_models.py::test_zero1_step_matches_plain_sgd`` at one
    rank: momentum 0 is plain SGD, here bit for bit on the CPU."""
    cfg = tt.TransformerLMConfig(**SMALL)
    init = tt.init_transformer_params(torch.Generator().manual_seed(0), cfg,
                                      device="cpu")
    params_a = {n: t.clone() for n, t in init.items()}
    params_b = {n: t.clone() for n, t in init.items()}
    tokens, labels = tt.place_batch(*_batch(8, 16), device="cpu")
    plain = tt.make_train_step(cfg, lr=0.3, device="cpu")
    zstep, momenta = tt.make_train_step_zero1(cfg, params_b, lr=0.3,
                                              momentum=0.0)
    for _ in range(3):
        params_a, loss_a = plain(params_a, tokens, labels)
        params_b, momenta, loss_b = zstep(params_b, momenta, tokens, labels)
        assert torch.equal(loss_a, loss_b)
    for n in params_a:
        assert torch.equal(params_a[n], params_b[n]), n
    # the steps update the clones in place and leave ``init`` as it was
    assert all(not torch.equal(params_a[n], init[n])
               for n in init if n.endswith(("wq", "w1", "out_proj")))


def test_train_step_loss_decreases():
    """``tests/test_models.py::test_train_step_loss_decreases`` at one
    device: 20 steps at lr 0.5 take the loss below 0.7 times the first."""
    cfg = tt.TransformerLMConfig(**SMALL)
    params = tt.init_transformer_params(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
    tokens, labels = tt.place_batch(*_batch(8, 16), device="cpu")
    step = tt.make_train_step(cfg, lr=0.5, device="cpu")
    losses = []
    for _ in range(20):
        params, loss = step(params, tokens, labels)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses[::5]
    assert np.isfinite(losses[-1])


def test_step_refuses_params_on_another_device():
    cfg = tt.TransformerLMConfig(**SMALL)
    params = tt.init_transformer_params(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
    params["layer0_wq"] = params["layer0_wq"].to("meta")
    tokens, labels = tt.place_batch(*_batch(), device="cpu")
    with pytest.raises(MXNetError):
        tt.make_train_step(cfg, device="cpu")(params, tokens, labels)


def test_place_batch_gives_int64_on_the_device():
    tokens, labels = _batch(2, 8)
    t, l_ = tt.place_batch(tokens, torch.from_numpy(labels), device="cpu")
    assert t.dtype == l_.dtype == torch.int64 and t.device.type == "cpu"
    assert np.array_equal(t.numpy(), tokens)
    assert np.array_equal(l_.numpy(), labels)


SPEC_SHAPES = [(), (7,), (8,), (8, 3), (12, 4, 4), (5, 16), (16,), (1, 1)]


@pytest.mark.parametrize("ndata", [1, 2, 4, 8])
@pytest.mark.parametrize("replicated", [True, False])
def test_zero1_update_spec_matches_jax(ndata, replicated):
    for shape in SPEC_SHAPES:
        # a weight split by tensor parallelism has "model" in its spec
        spec = [None] * len(shape)
        if not replicated:
            spec = ["model"] + spec[1:]
        want = jzero.zero1_update_spec(shape, jax.sharding.PartitionSpec(
            *spec), ndata) is not None
        assert tzero.zero1_update_spec(shape, replicated, ndata) == want, \
            (shape, replicated, ndata)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_state_bytes_matches_jax(n_shards):
    leaves = [((8, 3), np.float32, True), ((5,), np.float16, False),
              ((16, 4, 2), np.float64, True), ((), np.float32, False),
              ((7, 2), np.int32, True)]
    assert tzero.state_bytes(leaves, n_shards) == \
        jzero.state_bytes(leaves, n_shards)


class _Group:
    """Stands for a process group: only ``size()`` is read."""

    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


@pytest.mark.parametrize("group", [_Group(2), _Group(4)])
def test_sharded_update_raises_for_a_larger_group(group):
    """A data group of more than one rank shards the update over a
    ``torch.distributed`` process group (``tests/test_torch_parallel_lm.py``
    runs it on gloo ranks); a stand-in that only has ``size()`` raises,
    in the update and in the step builder."""
    p, g, m = torch.ones(4), torch.ones(4), torch.zeros(4)
    with pytest.raises(MXNetError, match="torch.distributed process group"):
        tzero.sharded_update(lambda *a: (a[0], a[2]), p, g, m, {}, group)
    cfg = tt.TransformerLMConfig(**SMALL)
    params = tt.init_transformer_params(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
    with pytest.raises(MXNetError, match="torch.distributed process group"):
        tt.make_train_step_zero1(cfg, params, group=group)


@pytest.mark.parametrize("group", [None, _Group(1)])
def test_sharded_update_runs_the_update_for_one_rank(group):
    p, g, m = torch.ones(4), torch.full((4,), 2.0), torch.zeros(4)

    def update(p, g, m, hyper):
        return p - hyper["lr"] * g, m + g
    new_p, new_m = tzero.sharded_update(update, p, g, m, {"lr": 0.5}, group)
    assert torch.equal(new_p, torch.zeros(4))
    assert torch.equal(new_m, g)
