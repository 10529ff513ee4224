"""Serialization of the PyTorch package against the JAX package on the
CPU: ``nd.save``/``load`` (the binary list format, V2 records and the
legacy V1/V0 ones), the ``stream`` schemes, Symbol JSON, and the
optimizer-state pickles of ``Updater.get_states``/``set_states``.

Each case of the JAX package's own tests (``tests/test_ndarray.py``'s
save/load cases, ``tests/test_legacy_formats.py``, the ``mem://``,
custom-scheme and local-path cases of ``tests/test_stream.py``, and the
JSON cases of ``tests/test_symbol.py``) runs here in both packages on
the same seeded inputs, and the results are compared.  Across the
packages: the bytes of ``save_to_bytes`` for every type code 0-7; each
package loading the other's ``.params``, ``-symbol.json`` and optimizer
states; the restricted unpickler's refusals; and a save-load cycle in a
fresh process that imports neither JAX, the JAX package nor
``ml_dtypes``.

Tolerances: none.  A file holds bits, so arrays are compared bit for bit
(bfloat16 as its 2-byte words), graphs as parsed JSON (``attrs.framework``
aside) and shapes exactly; the one computed comparison, a legacy graph's
forward, is exact too (its weights are zeros in both packages).
"""
import importlib.util
import io
import json
import os
import pickle
import struct
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import stream as jax_stream

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, _pickle
from mxnet_tpu_torch import stream as port_stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = (mx, mt)
DTYPES = ("float32", "float64", "float16", "uint8", "int32", "int8",
          "int64", "bfloat16")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


legacy = _load("test_legacy_formats", "tests/test_legacy_formats.py")


def bits(arr):
    """An NDArray of either package as a numpy array of its exact bits."""
    if isinstance(arr, mt.nd.NDArray):
        t = arr._data.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = arr.asnumpy()
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _same_arrays(a, b):
    """Two loads (lists or dicts of NDArrays) hold the same bits."""
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        pairs = [(a[k], b[k]) for k in a]
    else:
        assert len(a) == len(b)
        pairs = list(zip(a, b))
    for x, y in pairs:
        bx, by = bits(x), bits(y)
        assert bx.dtype == by.dtype and bx.shape == by.shape
        assert np.array_equal(bx, by)


def _host(pkg, values, dtype):
    return pkg.nd.array(values, ctx=pkg.cpu(), dtype=dtype)


def _values(rng, shape, dtype):
    if dtype in ("uint8", "int32", "int8", "int64"):
        return np.asarray(rng.randint(0, 100, shape), np.float32)
    return np.asarray(rng.randn(*shape) * 3, np.float32)


# -- tests/test_ndarray.py ----------------------------------------------------
def test_save_load_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    w, m = rng.rand(3, 4), np.arange(5)
    back = {}
    for pkg in PACKAGES:
        f = str(tmp_path / ("x_%s.params" % pkg.__name__))
        data = {"arg:w": pkg.nd.array(w, ctx=pkg.cpu()),
                "aux:m": pkg.nd.array(m, ctx=pkg.cpu(), dtype=np.int32)}
        pkg.nd.save(f, data)
        back[pkg] = pkg.nd.load(f)
        assert set(back[pkg]) == set(data)
        for k in data:
            np.testing.assert_array_equal(back[pkg][k].asnumpy(),
                                          data[k].asnumpy())
            assert back[pkg][k].dtype == data[k].dtype
    _same_arrays(back[mx], back[mt])
    assert back[mt]["arg:w"].context == mt.cpu()


def test_save_load_list(tmp_path):
    back = {}
    for pkg in PACKAGES:
        f = str(tmp_path / ("l_%s.params" % pkg.__name__))
        with pkg.cpu():
            pkg.nd.save(f, [pkg.nd.ones((2,)), pkg.nd.zeros((3, 3))])
        back[pkg] = pkg.nd.load(f)
        assert isinstance(back[pkg], list) and len(back[pkg]) == 2
        np.testing.assert_allclose(back[pkg][1].asnumpy(), np.zeros((3, 3)))
    _same_arrays(back[mx], back[mt])


# -- across the packages -------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_save_to_bytes_matches_byte_for_byte(dtype):
    """The same list or dict gives the JAX package's bytes exactly, for
    every type code: 2-D, 0-d, empty and 3-D arrays."""
    rng = np.random.RandomState(DTYPES.index(dtype))
    shapes = [(3, 4), (), (0, 3), (2, 1, 3)]
    vals = [_values(rng, s, dtype) for s in shapes]
    for make in (list, lambda xs: {"a%d" % i: x for i, x in enumerate(xs)}):
        raw = {pkg: pkg.nd.save_to_bytes(make(
            [_host(pkg, v, dtype) for v in vals])) for pkg in PACKAGES}
        assert raw[mt] == raw[mx]
        (code,) = struct.unpack_from("<i", raw[mt], 24 + 4 + 4 + 4 + 16 + 8)
        assert code == DTYPES.index(dtype)
        for reader, writer in ((mx, mt), (mt, mx)):
            _same_arrays(reader.nd.load_from_bytes(raw[writer]),
                         writer.nd.load_from_bytes(raw[writer]))
    one = {pkg: pkg.nd.save_to_bytes(_host(pkg, vals[0], dtype))
           for pkg in PACKAGES}
    assert one[mt] == one[mx]


def test_each_package_loads_the_others_params_file(tmp_path):
    rng = np.random.RandomState(1)
    vals = {"arg:w%d" % i: (_values(rng, (4, 3), dt), dt)
            for i, dt in enumerate(DTYPES)}
    files = {}
    for pkg in PACKAGES:
        files[pkg] = str(tmp_path / ("%s.params" % pkg.__name__))
        pkg.nd.save(files[pkg], {k: _host(pkg, v, dt)
                                 for k, (v, dt) in vals.items()})
    for reader, writer in ((mx, mt), (mt, mx)):
        _same_arrays(reader.nd.load(files[writer]),
                     writer.nd.load(files[writer]))


def test_save_copies_a_strided_array_as_c_contiguous():
    base = np.arange(24, dtype=np.float32).reshape(4, 6)
    port = mt.nd.NDArray(torch.from_numpy(base).t(), mt.cpu())
    assert not port._data.is_contiguous()
    ref = mx.nd.array(base.T, ctx=mx.cpu())
    assert mt.nd.save_to_bytes([port]) == mx.nd.save_to_bytes([ref])


@pytest.mark.parametrize("cut", [0, 7, 20, 30, 60, -9, -20])
def test_truncated_payload_raises_mxneterror(cut):
    raw = mt.nd.save_to_bytes({"w": mt.nd.array(np.ones((3, 4)),
                                                ctx=mt.cpu())})
    for pkg in PACKAGES:
        with pytest.raises(pkg.MXNetError):
            pkg.nd.load_from_bytes(raw[:cut])


def test_garbage_and_sparse_records_raise():
    for pkg in PACKAGES:
        with pytest.raises(pkg.MXNetError):
            pkg.nd.load_from_bytes(b"\xff" * 64)
        sparse = legacy._file([struct.pack("<Ii", legacy.V2_MAGIC, 1)
                               + b"\0" * 40])
        with pytest.raises(pkg.MXNetError, match="sparse"):
            pkg.nd.load_from_bytes(sparse)
        bad_code = legacy._file([struct.pack("<Ii", legacy.V2_MAGIC, 0)
                                 + struct.pack("<Iq", 1, 1)
                                 + struct.pack("<iii", 1, 0, 99) + b"\0" * 8])
        with pytest.raises(pkg.MXNetError):
            pkg.nd.load_from_bytes(bad_code)


# -- tests/test_legacy_formats.py ---------------------------------------------
def _both(fn):
    return {pkg: fn(pkg) for pkg in PACKAGES}


def test_v1_ndarray_record_loads(tmp_path):
    ref = np.arange(12, dtype=np.float32).reshape(3, 4)
    f = tmp_path / "v1.params"
    f.write_bytes(legacy._file([legacy._v1_record(ref)]))
    out = _both(lambda pkg: pkg.nd.load(str(f)))
    np.testing.assert_array_equal(out[mt][0].asnumpy(), ref)
    _same_arrays(out[mx], out[mt])


def test_v0_ndarray_record_loads(tmp_path):
    ref = np.arange(6, dtype=np.float32).reshape(2, 3)
    f = tmp_path / "v0.params"
    f.write_bytes(legacy._file([legacy._v0_record(ref)], keys=["arg:w"]))
    out = _both(lambda pkg: pkg.nd.load(str(f)))
    np.testing.assert_array_equal(out[mt]["arg:w"].asnumpy(), ref)
    _same_arrays(out[mx], out[mt])


def test_mixed_version_file(tmp_path):
    a = np.ones((2, 2), np.float32)
    b = np.full((3,), 7, np.float32)
    c = np.arange(4, dtype=np.float32)
    f = tmp_path / "mixed.params"
    f.write_bytes(legacy._file([legacy._v2_record(a), legacy._v1_record(b),
                                legacy._v0_record(c)], keys=["x", "y", "z"]))
    out = _both(lambda pkg: pkg.nd.load(str(f)))
    for k, v in (("x", a), ("y", b), ("z", c)):
        np.testing.assert_array_equal(out[mt][k].asnumpy(), v)
    _same_arrays(out[mx], out[mt])


def test_corrupt_magic_rejected(tmp_path):
    f = tmp_path / "bad.params"
    f.write_bytes(legacy._file([struct.pack("<I", 0xDEAD0000) + b"\0" * 64]))
    for pkg in PACKAGES:
        with pytest.raises(pkg.MXNetError):
            pkg.nd.load(str(f))


def _parsed(symbol):
    graph = json.loads(symbol.tojson())
    graph["attrs"].pop("framework")
    return graph


def test_attr_key_json_loads():
    def run(pkg):
        s = pkg.sym.load_json(legacy._legacy_json("attr", version=905))
        assert s.list_arguments() == ["data", "fc_weight", "fc_bias"]
        ex = s.simple_bind(pkg.cpu(), grad_req="null", data=(2, 4))
        ex.arg_dict["data"][:] = -np.ones((2, 4), np.float32)
        out = ex.forward()[0]
        assert out.shape == (2, 8)
        return _parsed(s), out.asnumpy()
    got = _both(run)
    assert got[mt][0] == got[mx][0]
    np.testing.assert_array_equal(got[mt][1], got[mx][1])


def test_param_key_json_loads():
    def run(pkg):
        s = pkg.sym.load_json(legacy._legacy_json("param"))
        assert s.list_outputs() == ["relu_output"]
        _, o, _ = s.infer_shape(data=(3, 5))
        assert o[0] == (3, 8)
        return _parsed(s)
    got = _both(run)
    assert got[mt] == got[mx]


def test_pre090_var_attr_hoist():
    graph = json.loads(legacy._legacy_json("param"))
    graph["nodes"][3]["param"]["lr_mult"] = "0.5"

    def run(pkg):
        s = pkg.sym.load_json(json.dumps(graph))
        node = s._outputs[0][0].inputs[0][0]
        assert node.attrs.get("__lr_mult__") == 0.5
        assert "lr_mult" not in node.attrs
        return _parsed(s)
    got = _both(run)
    assert got[mt] == got[mx]


def test_op_dtype_param_not_clobbered():
    graph = {
        "nodes": [
            {"op": "null", "name": "data", "param": {}, "inputs": []},
            {"op": "Cast", "name": "c", "param": {"dtype": "float16"},
             "inputs": [[0, 0]]},
        ],
        "arg_nodes": [0], "heads": [[1, 0]],
    }

    def run(pkg):
        s = pkg.sym.load_json(json.dumps(graph))
        _, o, _ = s.infer_type(data=np.float32)
        assert np.dtype(o[0]) == np.float16
        return _parsed(s)
    got = _both(run)
    assert got[mt] == got[mx]


def test_variable_flat_metadata_hoisted():
    graph = {
        "nodes": [
            {"op": "null", "name": "w",
             "attr": {"shape": "(3, 4)", "lr_mult": "2.0"}, "inputs": []},
        ],
        "arg_nodes": [0], "heads": [[0, 0]],
    }

    def run(pkg):
        s = pkg.sym.load_json(json.dumps(graph))
        node = s._outputs[0][0]
        assert node.attrs.get("__shape__") == (3, 4)
        assert node.attrs.get("__lr_mult__") == 2.0
        a, _, _ = s.infer_shape()
        assert a[0] == (3, 4)
        return _parsed(s)
    got = _both(run)
    assert got[mt] == got[mx]


def test_roundtrip_still_modern():
    def run(pkg):
        y = pkg.sym.Activation(pkg.sym.Variable("data"), act_type="tanh",
                               name="t")
        again = pkg.sym.load_json(y.tojson())
        assert again.tojson() == y.tojson()
        return _parsed(again)
    got = _both(run)
    assert got[mt] == got[mx]


# -- tests/test_stream.py (RecordIO waits for the data path) ------------------
def test_split_scheme():
    for st in (port_stream, jax_stream):
        assert st.split_scheme("s3://bucket/k") == ("s3", "bucket/k")
        assert st.split_scheme("mem://a/b.params") == ("mem", "a/b.params")
        assert st.split_scheme("/tmp/x.params") == (None, "/tmp/x.params")
        assert st.split_scheme("relative.rec") == (None, "relative.rec")
        assert st.split_scheme("C:/windows/path") == (None,
                                                      "C:/windows/path")
    assert port_stream.registered_schemes() == ["mem"]


def test_unknown_scheme_is_loud():
    for pkg, st in ((mt, port_stream), (mx, jax_stream)):
        with pytest.raises(pkg.MXNetError, match="register_scheme"):
            st.open_stream("s3://bucket/key", "rb")
    with pytest.raises(MXNetError, match="invalid scheme"):
        port_stream.register_scheme("not a scheme", None)


def test_custom_scheme_ndarray_roundtrip():
    """A user-registered fsspec-style opener carries nd.save/load; one
    store serves both packages, so each reads the other's file."""
    store = {}

    class _W(io.BytesIO):
        def __init__(self, key):
            super().__init__()
            self._key = key

        def close(self):
            store[self._key] = self.getvalue()
            super().close()

    def opener(uri, mode):
        key = port_stream.split_scheme(uri)[1]
        if "w" in mode:
            return _W(key)
        return io.BytesIO(store[key])

    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    for pkg, st in ((mt, port_stream), (mx, jax_stream)):
        assert st.register_scheme("fake", opener) is None
    try:
        for pkg in PACKAGES:
            pkg.nd.save("fake://%s/model.params" % pkg.__name__,
                        {"w": pkg.nd.array(w, ctx=pkg.cpu())})
        assert sorted(store) == ["mxnet_tpu/model.params",
                                 "mxnet_tpu_torch/model.params"]
        assert store["mxnet_tpu/model.params"] \
            == store["mxnet_tpu_torch/model.params"]
        for reader, writer in ((mx, mt), (mt, mx)):
            back = reader.nd.load("fake://%s/model.params"
                                  % writer.__name__)
            np.testing.assert_array_equal(back["w"].asnumpy(), w)
    finally:
        port_stream.unregister_scheme("fake")
        jax_stream.unregister_scheme("fake")
    for pkg in PACKAGES:
        with pytest.raises(pkg.MXNetError):
            pkg.nd.load("fake://mxnet_tpu/model.params")


def test_mem_scheme_symbol_and_checkpoint():
    """mem:// carries the -symbol.json + .params pair; each package keeps
    its own store, so the bytes cross through save_to_bytes."""
    saved = {}
    for pkg in PACKAGES:
        with pkg.cpu():
            net = pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                         num_hidden=3, name="fc")
            net.save("mem://m-symbol.json")
            loaded = pkg.sym.load("mem://m-symbol.json")
            assert loaded.tojson() == net.tojson()
            pkg.nd.save("mem://m.params",
                        {"arg:fc_weight": pkg.nd.ones((3, 5))})
            got = pkg.nd.load("mem://m.params")
            assert got["arg:fc_weight"].shape == (3, 5)
            saved[pkg] = (_parsed(loaded), pkg.nd.save_to_bytes(got))
    assert saved[mt] == saved[mx]
    with port_stream.open_stream("mem://from-jax.params", "wb") as f:
        f.write(saved[mx][1])
    _same_arrays(mt.nd.load("mem://from-jax.params"),
                 mx.nd.load_from_bytes(saved[mx][1]))
    with pytest.raises(FileNotFoundError):
        port_stream.open_stream("mem://missing", "rb")


def test_local_paths_unaffected(tmp_path):
    for pkg in PACKAGES:
        p = os.path.join(str(tmp_path), "x_%s.params" % pkg.__name__)
        with pkg.cpu():
            pkg.nd.save(p, [pkg.nd.zeros((2, 2))])
        assert pkg.nd.load(p)[0].shape == (2, 2)
        assert pkg.nd.load("file://" + p)[0].shape == (2, 2)
    assert open(os.path.join(str(tmp_path), "x_mxnet_tpu.params"),
                "rb").read() == open(os.path.join(
                    str(tmp_path), "x_mxnet_tpu_torch.params"), "rb").read()


# -- tests/test_symbol.py ----------------------------------------------------
def _mlp(pkg):
    s = pkg.sym
    net = s.FullyConnected(s.var("data"), num_hidden=16, name="fc1")
    net = s.Activation(net, act_type="relu", name="relu0")
    net = s.FullyConnected(net, num_hidden=10, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _resnet18(pkg):
    # the traced net's op nodes are named by the current name manager's
    # counters, so the trace runs in the fresh one too: the process's
    # global counters depend on what earlier tests built in each package
    with pkg.name.NameManager():
        net = pkg.gluon.model_zoo.vision.get_model(
            "resnet18_v1", classes=10, thumbnail=True)
        return pkg.sym.SoftmaxOutput(net(pkg.sym.Variable("data")),
                                     name="softmax")


def test_json_roundtrip():
    def run(pkg):
        net = _mlp(pkg)
        back = pkg.sym.load_json(net.tojson())
        assert back.list_arguments() == net.list_arguments()
        assert back.list_outputs() == net.list_outputs()
        assert back.list_auxiliary_states() == net.list_auxiliary_states()
        a1, o1, _ = back.infer_shape(data=(4, 50))
        a2, o2, _ = net.infer_shape(data=(4, 50))
        assert o1 == o2 and a1 == a2
        return _parsed(back), a1, o1
    got = _both(run)
    assert got[mt] == got[mx]


def test_json_file_roundtrip(tmp_path):
    for pkg in PACKAGES:
        net = _mlp(pkg)
        f = str(tmp_path / ("m-%s-symbol.json" % pkg.__name__))
        net.save(f)
        assert pkg.sym.load(f).tojson() == net.tojson()


def test_one_element_tuple_attr_roundtrip():
    from mxnet_tpu_torch.ops.registry import attr_to_string, \
        parse_attr_string
    assert attr_to_string((64,)) == "(64,)"
    assert parse_attr_string("(64,)") == (64,)
    for pkg in PACKAGES:
        s = pkg.sym.Variable("w", shape=(64,))
        loaded = pkg.sym.load_json(s.tojson())
        a, _, _ = loaded.infer_shape()
        assert a[0] == (64,)
        g = json.loads(s.tojson())
        for n in g["nodes"]:
            if n["name"] == "w":
                n["attrs"]["__shape__"] = "(64)"
        legacy_sym = pkg.sym.load_json(json.dumps(g))
        a, _, _ = legacy_sym.infer_shape()
        assert a[0] == (64,)


@pytest.mark.parametrize("graph", [_mlp, _resnet18], ids=["mlp", "resnet18"])
def test_each_package_loads_the_others_symbol_json(tmp_path, graph):
    """The same graph gives the same JSON (``attrs.framework`` aside), and
    each package reads the other's file back to it, with the same
    arguments, auxiliary states and inferred shapes."""
    files, nets = {}, {}
    for pkg in PACKAGES:
        nets[pkg] = graph(pkg)
        files[pkg] = str(tmp_path / ("%s-symbol.json" % pkg.__name__))
        nets[pkg].save(files[pkg])
    assert _parsed(nets[mt]) == _parsed(nets[mx])
    assert json.loads(nets[mt].tojson())["attrs"]["framework"] \
        == ["str", "mxnet_tpu_torch"]
    shape = (2, 50) if graph is _mlp else (2, 3, 32, 32)
    for reader, writer in ((mx, mt), (mt, mx)):
        back = reader.sym.load(files[writer])
        assert _parsed(back) == _parsed(nets[writer])
        assert back.list_arguments() == nets[writer].list_arguments()
        assert back.list_auxiliary_states() \
            == nets[writer].list_auxiliary_states()
        assert back.infer_shape(data=shape) \
            == nets[writer].infer_shape(data=shape)


# -- optimizer states ---------------------------------------------------------
# (optimizer, kwargs, weight dtype): SGD momentum, SGD without state, Adam,
# fp16 multi-precision SGD with and without momentum, and bf16 Adam
STATE_CASES = {
    "sgd_momentum": ("sgd", dict(learning_rate=0.1, momentum=0.9),
                     "float32"),
    "sgd_plain": ("sgd", dict(learning_rate=0.1), "float32"),
    "adam": ("adam", dict(learning_rate=0.01), "float32"),
    "sgd_fp16_multi_precision": (
        "sgd", dict(learning_rate=0.1, momentum=0.9, multi_precision=True),
        "float16"),
    "sgd_fp16_multi_precision_no_momentum": (
        "sgd", dict(learning_rate=0.1, multi_precision=True), "float16"),
    "adam_bf16": ("adam", dict(learning_rate=0.01), "bfloat16"),
}


def _updater_after_steps(pkg, name, kwargs, dtype, steps=2):
    rng = np.random.RandomState(3)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    ws = [_host(pkg, rng.randn(*s), dtype) for s in shapes]
    upd = pkg.optimizer.get_updater(pkg.optimizer.create(name, **kwargs))
    for _ in range(steps):
        for i, w in enumerate(ws):
            upd(i, _host(pkg, rng.randn(*w.shape) * 0.1, dtype), w)
    return upd


def _same_state_tree(a, b):
    """Two state structures: the same nesting, None where None, the same
    bits."""
    if a is None or b is None:
        assert a is None and b is None
        return
    if isinstance(a, tuple) or isinstance(b, tuple):
        assert isinstance(a, tuple) and isinstance(b, tuple)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_state_tree(x, y)
        return
    bx, by = bits(a), bits(b)
    assert bx.dtype == by.dtype and bx.shape == by.shape
    assert np.array_equal(bx, by)


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_each_package_loads_the_others_states(case):
    name, kwargs, dtype = STATE_CASES[case]
    upd = {pkg: _updater_after_steps(pkg, name, kwargs, dtype)
           for pkg in PACKAGES}
    for reader, writer in ((mx, mt), (mt, mx)):
        blob = upd[writer].get_states()
        fresh = reader.optimizer.get_updater(
            reader.optimizer.create(name, **kwargs))
        fresh.set_states(blob)
        assert sorted(fresh.states) == sorted(upd[writer].states)
        for idx in upd[writer].states:
            _same_state_tree(fresh.states[idx], upd[writer].states[idx])
    if dtype == "float32":
        # the same updates in both packages give states within fp32 of
        # each other; the structures are the same
        for idx in upd[mt].states:
            _same_structure(upd[mt].states[idx], upd[mx].states[idx])


def _same_structure(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_structure(x, y)
    else:
        assert (a is None) == (b is None)


def test_loaded_states_land_on_cpu_and_move_to_the_weight():
    upd = _updater_after_steps(mx, "sgd", dict(learning_rate=0.1,
                                               momentum=0.9), "float32")
    port = mt.optimizer.get_updater(mt.optimizer.SGD(learning_rate=0.1,
                                                     momentum=0.9))
    port.set_states(upd.get_states())
    assert all(s.context == mt.cpu() for s in port.states.values())
    w = _host(mt, np.ones((4, 3)), "float32")
    assert port.state_for(0, w) is port.states[0]
    w1 = mt.nd.NDArray(w._data.clone(), mt.cpu(1))
    moved = port.state_for(0, w1)
    assert moved.context == mt.cpu(1) and port.states[0] is moved
    assert np.array_equal(bits(moved), bits(upd.states[0]))


def test_dump_optimizer_raises():
    """``get_states(dump_optimizer=True)``: the port's dump reads back in
    the port (the optimizer's class and hyper-parameters with the states)
    and in the JAX package; the JAX package's dump reads in the port, its
    optimizer mapped to the port's class of the same name.  What still
    raises: dumping an optimizer class neither package registers, and
    reading a pickle that names one."""
    class MyRule(mt.optimizer.SGD):
        pass

    with pytest.raises(MXNetError, match="MyRule"):
        mt.optimizer.get_updater(MyRule()).get_states(dump_optimizer=True)
    # (states, MyRule()) as the JAX package would pickle it
    unknown = b"\x80\x04}cmxnet_tpu.optimizer\nMyRule\n)\x81}b\x86."
    with pytest.raises(_pickle.UnpicklingRefused, match="MyRule"):
        mt.optimizer.get_updater(mt.optimizer.SGD()).set_states(unknown)
    upd = mt.optimizer.get_updater(mt.optimizer.SGD())
    upd.set_states(_pickle.dumps(({0: None}, None)))
    assert upd.states == {0: None}
    for name, kwargs in (("sgd", dict(learning_rate=0.1, momentum=0.9)),
                         ("adam", dict(learning_rate=0.01, wd=1e-4))):
        ref = _updater_after_steps(mx, name, kwargs, "float32")
        port = _updater_after_steps(mt, name, kwargs, "float32")
        for src, blob in (("port", port.get_states(dump_optimizer=True)),
                          ("ref", ref.get_states(dump_optimizer=True))):
            back = mt.optimizer.get_updater(mt.optimizer.Test())
            back.set_states(blob)
            want = port if src == "port" else ref
            assert type(back.optimizer).__name__ \
                == type(want.optimizer).__name__
            assert type(back.optimizer).__module__ == "mxnet_tpu_torch." \
                "optimizer"
            for key in ("lr", "wd", "num_update", "_index_update_count"):
                assert getattr(back.optimizer, key) \
                    == getattr(want.optimizer, key), key
            for k in want.states:
                _same_state_tree(back.states[k], want.states[k])
        in_ref = mx.optimizer.get_updater(mx.optimizer.Test())
        in_ref.set_states(port.get_states(dump_optimizer=True))
        assert type(in_ref.optimizer) is type(ref.optimizer)
        assert in_ref.optimizer.num_update == ref.optimizer.num_update
        for k in ref.states:
            _same_state_tree(in_ref.states[k], port.states[k])


def test_state_pickle_refuses_other_globals():
    """A pickle naming ``os.system`` (or any global outside the safe
    builtins, numpy and the package's table) raises and runs nothing."""
    marker = "/nonexistent/should-not-run"
    evil = b"cos\nsystem\n(X" + struct.pack("<I", len(marker) + 6) \
        + b"touch " + marker.encode() + b"tR."
    for blob in (evil, pickle.dumps({0: print}),
                 pickle.dumps(mt.optimizer.SGD)):
        with pytest.raises(_pickle.UnpicklingRefused, match="disallowed"):
            _pickle.loads(blob)
        with pytest.raises(MXNetError):
            mt.optimizer.get_updater(mt.optimizer.SGD()).set_states(blob)
        with pytest.raises(pickle.UnpicklingError):
            _pickle.loads(blob)
    assert _pickle.loads(pickle.dumps({"a": (1, 2.5, None, b"x", [True]),
                                       3: frozenset({1})})) \
        == {"a": (1, 2.5, None, b"x", [True]), 3: frozenset({1})}


def test_state_pickle_emitter_payload_types():
    payload = {0: None, 1: (True, False), -7: [2 ** 40, -2 ** 70, 0.1],
               "s": ("é", b"\x00\xff", ()), 5: {}, 6: []}
    blob = _pickle.dumps(payload)
    assert pickle.loads(blob) == payload
    assert _pickle.loads(blob) == payload
    with pytest.raises(TypeError):
        _pickle.dumps({0: object()})


def test_ndarray_plain_pickle_keeps_dtype_and_context():
    for dt in ("float32", "bfloat16", "int64"):
        a = _host(mt, np.arange(6).reshape(2, 3), dt)
        b = pickle.loads(pickle.dumps(a))
        assert b.context == mt.cpu() and b._data.dtype == a._data.dtype
        assert np.array_equal(bits(b), bits(a))


def test_reference_ndarray_pickle_reads_in_the_port():
    """A plain pickle of the JAX package's NDArrays (numpy's protocol 3-4
    and protocol-5 reductions, bfloat16 through ``ml_dtypes``) reads as
    the port's NDArrays on ``cpu(0)``, a sparse-tagged one with its tag."""
    rng = np.random.RandomState(9)
    for dt in DTYPES:
        v = _values(rng, (3, 2), dt)
        ref = _host(mx, v, dt)
        for proto in (3, 4, 5):
            got = _pickle.loads(pickle.dumps({"x": [ref]}, protocol=proto))
            assert got["x"][0].context == mt.cpu()
            assert np.array_equal(bits(got["x"][0]), bits(ref))
    # a sparse-tagged array reads as the JAX package restores it: dense,
    # with its tag (ROADMAP C.8)
    sparse = mx.nd.array(np.ones(2), ctx=mx.cpu())
    sparse._stype = "csr"
    got = _pickle.loads(pickle.dumps(sparse))
    back = pickle.loads(pickle.dumps(sparse))
    assert got.stype == back.stype == "csr"
    assert got.context == mt.cpu()
    assert np.array_equal(got.asnumpy(), back.asnumpy())


def test_save_load_leaves_no_jax_in_a_fresh_process(tmp_path):
    """A save-load cycle of every format in a process of its own imports
    neither JAX, the JAX package nor ``ml_dtypes``."""
    code = r"""
import sys, os
import numpy as np
import mxnet_tpu_torch as mt
d = sys.argv[1]
with mt.cpu():
    w = mt.nd.array(np.arange(6).reshape(2, 3), dtype="bfloat16")
    mt.nd.save(os.path.join(d, "x.params"), {"w": w, "f": w.astype("float32")})
    assert mt.nd.load(os.path.join(d, "x.params"))["w"].dtype == w.dtype
    net = mt.sym.FullyConnected(mt.sym.var("data"), num_hidden=2, name="fc")
    mod = mt.mod.Module(mt.sym.SoftmaxOutput(net, name="softmax"),
                        context=mt.cpu())
    mod.bind(data_shapes=[("data", (4, 3))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params()
    mod.init_optimizer(optimizer="adam")
    mod._fit_step(mt.io.DataBatch([mt.nd.ones((4, 3))], [mt.nd.zeros((4,))]))
    prefix = os.path.join(d, "ck")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    mod2 = mt.mod.Module.load(prefix, 1, load_optimizer_states=True,
                              context=mt.cpu())
    mod2.bind(data_shapes=[("data", (4, 3))],
              label_shapes=[("softmax_label", (4,))])
    mod2.init_optimizer(optimizer="adam")
    upd = mt.optimizer.get_updater(mt.optimizer.Adam())
    upd(0, w, w.copy())
    mt.optimizer.get_updater(mt.optimizer.Adam()).set_states(upd.get_states())
    blk = mt.gluon.nn.Dense(2, in_units=3)
    blk.initialize()
    tr = mt.gluon.Trainer(blk.collect_params(), "adam")
    tr.save_states(os.path.join(d, "t.states"))
    tr.load_states(os.path.join(d, "t.states"))
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu", "ml_dtypes")))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
