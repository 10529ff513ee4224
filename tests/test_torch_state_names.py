"""``state_names`` of ``Module`` and ``BucketingModule`` against the JAX
package on the CPU: the names are filed among the parameters
(``mxnet_tpu/module/module.py:66-79``), the executor group keeps them
(``executor_group.py:40-49``), ``get_states`` returns ``[]`` and
``set_states`` only checks that the module is ready
(``base_module.py:280-285``; ``BucketingModule`` forwards both to its
active module, ``bucketing_module.py:144-150``).  One SGD step from the
same parameters, in fp64, gives the same parameters (state included)
within 1e-12.
"""
import numpy as np
import pytest

import jax
import mxnet_tpu as mx

import mxnet_tpu_torch as mt

BATCH, IN, HID = 4, 6, 3


@pytest.fixture(scope="module", autouse=True)
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _sym_gen(pkg):
    def gen(key):
        fc = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=HID,
                                    name="st_fc")
        out = fc + pkg.sym.Variable("st_state", shape=(BATCH, HID))
        return (pkg.sym.SoftmaxOutput(out, name="softmax"), ("data",),
                ("softmax_label",))
    return gen


def _module(pkg, kind, states=("st_state",)):
    gen = _sym_gen(pkg)
    kw = dict(context=pkg.cpu(), state_names=list(states))
    if kind == "module":
        return pkg.mod.Module(gen(IN)[0], **kw)
    return pkg.mod.BucketingModule(gen, default_bucket_key=IN, **kw)


def _params():
    rng = np.random.RandomState(11)
    return {"st_fc_weight": rng.randn(HID, IN), "st_fc_bias": rng.randn(HID),
            "st_state": rng.randn(BATCH, HID)}


def _train(pkg, kind):
    """Bind, set the parameters, one SGD step; (module, parameter names,
    states before and after the step, parameters after)."""
    mod = _module(pkg, kind)
    f64 = "float64"
    mod.bind([pkg.io.DataDesc("data", (BATCH, IN), dtype=f64)],
             [pkg.io.DataDesc("softmax_label", (BATCH,), dtype=f64)])
    ctx = pkg.cpu()
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx, dtype=f64)
                                for k, v in _params().items()},
                    aux_params={})
    mod.init_optimizer(optimizer_params=(("learning_rate", 0.1),))
    before = mod.get_states()
    mod.set_states(value=0)
    rng = np.random.RandomState(12)
    batch = pkg.io.DataBatch(
        [pkg.nd.array(rng.randn(BATCH, IN), ctx=ctx, dtype=f64)],
        [pkg.nd.array(rng.randint(0, HID, BATCH), ctx=ctx, dtype=f64)],
        bucket_key=IN)
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    arg, _ = mod.get_params()
    inner = mod if kind == "module" else mod._active
    return (inner._param_names, inner._state_names, before,
            mod.get_states(), {k: v.asnumpy() for k, v in arg.items()})


@pytest.mark.parametrize("kind", ["module", "bucketing"])
def test_state_names_match_jax(kind):
    with mt.cpu():
        port = _train(mt, kind)
    ref = _train(mx, kind)
    assert port[0] == ref[0] and "st_state" in port[0]
    assert port[1] == ref[1] == ["st_state"]
    assert port[2] == ref[2] == [] and port[3] == ref[3] == []
    assert sorted(port[4]) == sorted(ref[4])
    for k in ref[4]:
        np.testing.assert_allclose(port[4][k], ref[4][k], rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["module", "bucketing"])
def test_states_need_a_ready_module(kind):
    for pkg in (mt, mx):
        with pkg.cpu():
            mod = _module(pkg, kind)
            for call in (mod.get_states, mod.set_states):
                with pytest.raises(AssertionError):
                    call()


def test_executor_group_keeps_the_state_names():
    with mt.cpu():
        mod = _module(mt, "module")
        mod.bind([("data", (BATCH, IN))], [("softmax_label", (BATCH,))])
    assert mod._exec_group.state_names == ["st_state"]
    assert mod._exec_group.grad_req["st_state"] == "write"


@pytest.mark.parametrize("states", [(), ("st_state",)])
def test_bucketing_module_takes_state_names(states):
    """No longer refused: every bucket's module gets them."""
    with mt.cpu():
        mod = _module(mt, "bucketing", states)
        mod.bind([("data", (BATCH, IN))], [("softmax_label", (BATCH,))])
    assert mod._active._state_names == list(states)
