"""The API surface around a training script, in the PyTorch package
against the JAX package: top-level names, ``AttrScope``, the Symbol's
introspection and methods, ``random.current_seed``, ``cpu_pinned``,
``log``, ``contrib``, and the Symbol JSON of two examples that use them.

Mirrors ``tests/test_symbol.py`` (``get_internals``,
``attr_scope_and_var_attrs``, ``debug_str``), ``tests/test_contrib_misc.py
:16-40`` and ``tests/test_profiler_monitor_viz.py``'s ``get_logger``.
Text (``debug_str``, JSON) is held equal exactly; values of the Symbol
methods bit for bit, softmax within 2 fp32 ulps (XLA's and torch's
exponentials differ in the last bit).
"""
import builtins
import copy
import importlib.util
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

PKGS = {"jax": mx, "torch": mt}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def x64():
    """The JAX package turns x64 on at import; another test may have
    turned it off in this worker (``astype("float64")`` needs it)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _example(name):
    path = os.path.join(REPO, "examples", name + ".py")
    spec = importlib.util.spec_from_file_location("_ex_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def with_package(fn, pkg):
    """``fn`` (an example's network function) with ``mxnet_tpu`` meaning
    ``pkg``: its global ``mx`` and its own ``import mxnet_tpu``
    statements."""
    real = builtins.__import__

    def imp(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "mxnet_tpu" or name.startswith("mxnet_tpu."):
            name = pkg.__name__ + name[len("mxnet_tpu"):]
        return real(name, globals, locals, fromlist, level)
    env = dict(fn.__globals__, mx=pkg,
               __builtins__=dict(vars(builtins), __import__=imp))
    return types.FunctionType(fn.__code__, env, fn.__name__,
                              fn.__defaults__, fn.__closure__)


def graph_json(symbol):
    """The symbol's JSON with ``attrs.framework`` (the package's name)
    taken out."""
    graph = json.loads(symbol.tojson())
    graph["attrs"].pop("framework")
    return json.dumps(graph, indent=2)


def _mlp(pkg):
    data = pkg.sym.var("data")
    h = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    h = pkg.sym.Activation(h, act_type="relu", name="act1")
    return pkg.sym.FullyConnected(h, num_hidden=3, name="fc2")


TOP_LEVEL = ("seed", "Symbol", "Executor", "NameManager", "opt", "AttrScope",
             "attribute", "cpu_pinned", "Monitor", "monitor", "FeedForward",
             "visualization", "viz", "log", "contrib", "name")


@pytest.mark.parametrize("name", TOP_LEVEL)
def test_top_level_name(name):
    ours, theirs = getattr(mt, name), getattr(mx, name)
    assert type(ours).__name__ == type(theirs).__name__
    if isinstance(theirs, types.ModuleType):
        assert ours.__name__ == theirs.__name__.replace("mxnet_tpu",
                                                        "mxnet_tpu_torch")
    else:
        assert ours.__name__ == theirs.__name__


def test_attr_scope_and_var_attrs():
    for pkg in PKGS.values():
        with pkg.AttrScope(ctx_group="dev1"):
            v = pkg.sym.var("w")
        assert v.attr("ctx_group") == "dev1"
        v2 = pkg.sym.var("x", shape=(3, 4), lr_mult=2.0)
        _, out, _ = v2.infer_shape()
        assert out == [(3, 4)]


def test_attr_scope_nests_and_marks_variables_only():
    dicts = {}
    for key, pkg in PKGS.items():
        with pkg.name.NameManager():
            with pkg.AttrScope(ctx_group="a", stage="1"):
                x = pkg.sym.var("x")
                with pkg.AttrScope(ctx_group="b"):
                    w = pkg.sym.var("w", attr={"stage": "2"})
                    y = pkg.sym.FullyConnected(x, weight=w, num_hidden=2,
                                               no_bias=True, name="fc")
            z = pkg.sym.var("z")
        assert pkg.attribute.current().get(None) == {}
        assert x.attr("ctx_group") == "a" and w.attr("ctx_group") == "b"
        assert w.attr("stage") == "2" and z.list_attr() == {}
        assert y.attr("ctx_group") is None
        dicts[key] = (y.attr_dict(), x.list_attr(), w.list_attr())
        with pytest.raises(ValueError):
            pkg.AttrScope(ctx_group=1)
    assert dicts["torch"] == dicts["jax"]


def test_get_internals():
    for pkg in PKGS.values():
        internals = _mlp(pkg).get_internals()
        assert "fc1_output" in internals.list_outputs()
        fc1 = internals["fc1_output"]
        assert fc1.list_arguments() == ["data", "fc1_weight", "fc1_bias"]
    assert _mlp(mt).get_internals().list_outputs() \
        == _mlp(mx).get_internals().list_outputs()


def test_get_children_and_copies():
    for pkg in PKGS.values():
        net = _mlp(pkg)
        kids = net.get_children()
        assert kids.list_outputs() == ["act1_output", "fc2_weight",
                                       "fc2_bias"]
        assert pkg.sym.var("v").get_children() is None
        deep = copy.deepcopy(net)
        assert deep is not net and deep.tojson() == net.tojson()
        assert copy.copy(net).list_outputs() == net.list_outputs()


def _bind_values(pkg, make, x):
    ctx = pkg.cpu()
    s = make(pkg.sym.var("x"))
    out = s.eval(ctx=ctx, x=pkg.nd.array(x, ctx=ctx))
    return [o.asnumpy() for o in out]


METHODS = {
    "astype": lambda s: s.astype("float64"),
    "transpose": lambda s: s.transpose(axes=(1, 0, 2)),
    "transpose_default": lambda s: s.transpose(),
    "slice_axis": lambda s: s.slice_axis(axis=2, begin=1, end=3),
    "softmax": lambda s: s.softmax(axis=1),
}


@pytest.mark.parametrize("method", sorted(METHODS))
def test_symbol_method_values(method):
    x = np.random.RandomState(5).randn(2, 3, 4).astype(np.float32)
    got = _bind_values(mt, METHODS[method], x)
    want = _bind_values(mx, METHODS[method], x)
    assert len(got) == len(want) == 1
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    if method == "softmax":
        np.testing.assert_array_max_ulp(got[0], want[0], maxulp=2)
    else:
        np.testing.assert_array_equal(got[0], want[0])


def test_debug_str_text_equals_reference():
    texts = {}
    for key, pkg in PKGS.items():
        with pkg.name.NameManager():
            data = pkg.sym.Variable("data")
            h = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
            out = pkg.sym.Activation(h, act_type="relu", name="act1")
            s = out.debug_str()
            g = pkg.sym.Group([h, out]).debug_str()
            plus = (out * 2.0 + h).debug_str()
        assert "Variable:data" in s and "act_type=relu" in s
        fc_block = s.split("Op:FullyConnected")[1].split("---")[0]
        assert "arg[0]=data" in fc_block and "arg[2]=fc1_bias" in fc_block
        assert "output[0]=fc1_output" in g and "output[1]=act1_output" in g
        texts[key] = (s, g, plus)
    assert texts["torch"] == texts["jax"]


def test_eval_binds_on_the_current_context():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    s = mt.sym.var("x") * 2.0
    with mt.cpu():
        out = s.eval(x=mt.nd.array(x))
    assert out[0].context == mt.cpu()
    np.testing.assert_array_equal(out[0].asnumpy(), 2 * x)
    if not torch.cuda.is_available():
        with pytest.raises(mt.MXNetError):
            s.eval(x=mt.nd.array(x, ctx=mt.cpu()))


def test_current_seed():
    for pkg in PKGS.values():
        pkg.random.seed(123)
        assert pkg.random.current_seed() == 123
        pkg.seed(7)
        assert pkg.random.current_seed() == 7
    mt.random.seed(9, ctx=mt.cpu())
    assert mt.random.current_seed() == 9


def test_cpu_pinned_context():
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    for pkg in PKGS.values():
        ctx = pkg.cpu_pinned()
        assert ctx.device_type == "cpu_pinned" and str(ctx) == "cpu_pinned(0)"
        assert ctx != pkg.cpu() and ctx == pkg.context.cpu_pinned(0)
        a = pkg.nd.array(x, ctx=ctx)
        assert a.context == ctx
        np.testing.assert_array_equal(a.asnumpy(), x)
        np.testing.assert_array_equal(
            a.copyto(pkg.cpu()).asnumpy(), (pkg.nd.array(x, ctx=pkg.cpu())
                                             .copyto(ctx)).asnumpy())
    pinned = torch.cuda.is_available()
    a = mt.nd.zeros((2, 2), ctx=mt.cpu_pinned())
    assert a._data.device.type == "cpu" and a._data.is_pinned() == pinned
    assert mt.nd.array(x, ctx=mt.cpu()).copyto(
        mt.cpu_pinned())._data.is_pinned() == pinned


class _CopyEvent:
    """Stands in for the CUDA event of a copy to the card in flight."""
    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


@pytest.mark.parametrize("write", ["setitem", "set_data", "iadd", "copyto",
                                   "out", "wait_to_write"])
def test_host_write_waits_for_a_copy_in_flight(write):
    """A write to a page-locked array whose copy to the card has not yet
    run waits for it first (on the card ``copyto`` records the event),
    so the copy holds the values of the time of the call."""
    a = mt.nd.array(np.zeros((2, 2), np.float32), ctx=mt.cpu_pinned())
    ev = a._reading = _CopyEvent()
    one = mt.nd.ones((2, 2), ctx=mt.cpu())
    if write == "setitem":
        a[:] = 1.0
    elif write == "set_data":
        a._set_data(one._data)
    elif write == "iadd":
        a += one
    elif write == "copyto":
        one.copyto(a)
    elif write == "out":
        mt.nd.elemwise_add(one, one, out=a)
    else:
        a.wait_to_write()
    assert ev.waits == 1 and a._reading is None
    # a copy to another host context runs at once and leaves no event
    a.copyto(mt.cpu())
    assert a._reading is None


def test_get_logger(tmp_path):
    for key, pkg in PKGS.items():
        path = tmp_path / ("%s.log" % key)
        logger = pkg.log.get_logger("mxtest_" + key, filename=str(path),
                                    level=pkg.log.INFO)
        logger.info("hello")
        line = path.read_text().strip()
        assert line.startswith("I") and line.endswith("] hello")


def test_contrib_autograd_old_api():
    grads = []
    for pkg in PKGS.values():
        x = pkg.nd.array(np.array([2.0, 3.0], np.float32), ctx=pkg.cpu())
        g = pkg.nd.zeros((2,), ctx=pkg.cpu())
        pkg.contrib.autograd.mark_variables([x], [g])
        with pkg.contrib.autograd.train_section():
            y = x * x
        pkg.contrib.autograd.compute_gradient([y])
        grads.append(g.asnumpy())
    np.testing.assert_array_equal(grads[0], [4.0, 6.0])
    np.testing.assert_array_equal(grads[1], grads[0])


def test_tensorboard_callback_jsonl(tmp_path):
    rows = {}
    for key, pkg in PKGS.items():
        from importlib import import_module
        tb = import_module(pkg.__name__ + ".contrib.tensorboard")
        d = tmp_path / key
        cb = tb.LogMetricsCallback(str(d), prefix="train")
        cb._writer = tb._JsonlWriter(str(d))   # the hermetic writer
        metric = pkg.metric.Accuracy()
        metric.update([pkg.nd.array(np.array([1.0]), ctx=pkg.cpu())],
                      [pkg.nd.array(np.array([[0.2, 0.8]]), ctx=pkg.cpu())])
        cb(pkg.model.BatchEndParam(epoch=0, nbatch=1, eval_metric=metric))
        got = [json.loads(line) for line in
               open(d / "scalars.jsonl").read().splitlines()]
        rows[key] = [(r["step"], r["tag"], r["value"]) for r in got]
    assert rows["torch"] == rows["jax"] == [(1, "train-accuracy", 1.0)]


def test_tensorboard_writer_choice_follows_the_reference(tmp_path):
    from mxnet_tpu.contrib import tensorboard as ref
    from mxnet_tpu_torch.contrib import tensorboard as port
    ours = port._make_writer(str(tmp_path / "a"))
    theirs = ref._make_writer(str(tmp_path / "b"))
    assert type(ours) is type(theirs)
    for w in (ours, theirs):
        if w is not None:
            w.close()


def test_model_parallel_lstm_json_equals_reference():
    build = _example("model_parallel_lstm").build_stacked_lstm
    texts = {}
    for key, pkg in PKGS.items():
        with pkg.name.NameManager():
            net = with_package(build, pkg)(6, 16, 4)
        texts[key] = graph_json(net)
    assert texts["torch"] == texts["jax"]
    groups = {n["attrs"].get("ctx_group") for n in
              json.loads(texts["torch"])["nodes"]}
    assert groups == {None, "embed", "layer0", "layer1", "head"}
    assert all("ctx_group" not in n["attrs"]
               for n in json.loads(texts["torch"])["nodes"]
               if n["op"] != "null")


@pytest.mark.parametrize("style", ["fcn32s", "fcn8s"])
def test_fcn_xs_json_and_mixed_initializer_equal_reference(style):
    fcn = _example("fcn_xs").fcn_symbol
    texts, params = {}, {}
    for key, pkg in PKGS.items():
        with pkg.name.NameManager():
            net = with_package(fcn, pkg)(3, style)
        texts[key] = graph_json(net)
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.bind(data_shapes=[("data", (2, 3, 16, 16))],
                 label_shapes=[("softmax_label", (2, 16, 16))])
        pkg.random.seed(11)
        mod.init_params(initializer=pkg.initializer.Mixed(
            ["(score2|score4|bigscore)_weight", ".*"],
            [pkg.initializer.Bilinear(), pkg.initializer.Xavier()]))
        arg, _ = mod.get_params()
        params[key] = {n: a.asnumpy() for n, a in arg.items()}
    assert texts["torch"] == texts["jax"]
    assert sorted(params["torch"]) == sorted(params["jax"])
    for n, want in params["jax"].items():
        np.testing.assert_array_equal(params["torch"][n], want, err_msg=n)
