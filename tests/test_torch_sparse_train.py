"""The sparse data path and the sparse examples against the JAX package on
the CPU: ``LibSVMIter`` over two epochs in ``roll_over`` and ``pad``
(a label file, repeated ids, ids past the width, explicit zeros), then
``examples/sparse_linear_classification.py``'s model through ``Module``
(without a store, and with ``kv.create("local")`` and ``row_sparse_pull``
as the example's loop runs it) and ``examples/factorization_machine.py``'s
FM through ``_fit_step``, 3 steps each from the JAX package's initial
parameters at the examples' own small sizes.

Batches are held bit for bit.  The models are held in float32: the JAX
package multiplies the CSR's dense backing and the port its parts, in
another order, so outputs and parameters are held to rtol 1e-5 and atol
1e-6 (Adam's normalised steps to atol 1e-5).
"""
import importlib.util
import os

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.ops import sparse_dot as sd

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        "example_" + name, os.path.join(REPO, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


def _batch_rows(it):
    out = []
    for b in it:
        d = b.data[0]
        out.append((d.stype, d.shape, d.data.asnumpy(), d.indices.asnumpy(),
                    d.indptr.asnumpy(), d.asnumpy(),
                    [l.asnumpy() for l in b.label], b.pad))
    return out


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0] == "csr" and tuple(x[1]) == tuple(y[1])
        for u, v in zip(x[2:6], y[2:6]):
            np.testing.assert_array_equal(u, v)
        assert len(x[6]) == len(y[6])
        for u, v in zip(x[6], y[6]):
            np.testing.assert_array_equal(u, v)
        assert x[7] == y[7]


LINES = ["1 0:1.5 3:2.0 3:4.0 7:1.0", "0 1:0.5 9:3 12:1", "1 2:3.0 3:0",
         "0 0:2.5 5:-0.0", "1 1:0 2:1 2:0", "0 6:1e-3 4:2 6:7", "1 8:5 0:0.25"]


@pytest.mark.parametrize("round_batch", [True, False])
@pytest.mark.parametrize("batch_size", [2, 3])
@pytest.mark.parametrize("label_file", [False, True])
def test_libsvm_iter_matches_over_two_epochs(tmp_path, round_batch,
                                             batch_size, label_file):
    """Repeated ids (the last wins), ids at or past the width (dropped),
    explicit zeros (dropped), a label file of shape (2,): every batch's
    parts, values, labels and pad equal over two epochs."""
    data = tmp_path / "d.libsvm"
    data.write_text("\n".join(LINES) + "\n")
    kwargs = dict(data_libsvm=str(data), data_shape=(9,),
                  batch_size=batch_size, round_batch=round_batch)
    if label_file:
        labels = tmp_path / "l.libsvm"
        labels.write_text("".join("0 0:%d 1:%d\n" % (i, 2 * i)
                                  for i in range(len(LINES))))
        kwargs.update(label_libsvm=str(labels), label_shape=(2,))
    runs = {}
    for pkg in (mt, mx):
        it = pkg.io.LibSVMIter(**kwargs)
        runs[pkg] = [_batch_rows(it)]
        it.reset()
        runs[pkg].append(_batch_rows(it))
        assert [tuple(d) for d in it.provide_data] == [("data",
                                                        (batch_size, 9))]
    for a, b in zip(runs[mt], runs[mx]):
        _same_batches(a, b)


def test_libsvm_batches_stay_compressed(tmp_path):
    """A batch at width 10^7 builds no dense matrix; its parts sit on the
    host."""
    data = tmp_path / "wide.libsvm"
    data.write_text("1 0:1 9999999:2\n0 5:3\n")
    before = profiler.counter(sd.DENSIFY_COUNTER)
    b = mt.io.LibSVMIter(data_libsvm=str(data), data_shape=(10 ** 7,),
                         batch_size=2).next()
    d = b.data[0]
    assert d.shape == (2, 10 ** 7) and d.context == mt.cpu()
    np.testing.assert_array_equal(d.indices.asnumpy(), [0, 9999999, 5])
    assert profiler.counter(sd.DENSIFY_COUNTER) == before


def _linear_runs(tmp_path, kv_kind):
    """3 steps of the linear example's loop in both packages from the JAX
    package's initial parameters; (port, reference) losses, params."""
    ex = _example("sparse_linear_classification")
    path = str(tmp_path / "linear.libsvm")
    ex.synthetic_libsvm(path, n=256, dim=300)
    out = {}
    for pkg in (mx, mt):
        it = pkg.io.LibSVMIter(data_libsvm=path, data_shape=(300,),
                               batch_size=64)
        sym = ex.linear_model(300, positive_cls_weight=2.0) if pkg is mx \
            else cs.sparse_linear_symbol(mt, 300)
        kv = pkg.kv.create(kv_kind) if kv_kind else None
        if pkg is mx:
            mx.random.seed(0)
            mod = mx.mod.Module(sym, data_names=["data"],
                                label_names=["softmax_label"],
                                context=mx.cpu())
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mod.init_params()
            init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
            mod.init_optimizer(kvstore=kv, optimizer="sgd",
                               optimizer_params=(("learning_rate", 0.5),))
        else:
            mod = cs.sparse_module(mt, sym, mt.cpu(), it.provide_data,
                                   it.provide_label, "sgd",
                                   (("learning_rate", 0.5),), kv=kv,
                                   params=mt.mod.params_from_jax(
                                       init, {}, sym))
        before = profiler.counter(sd.DENSIFY_COUNTER)
        losses = [cs.sparse_linear_step(mod, b, kv)
                  for b, _ in zip(it, range(3))]
        if pkg is mt:
            assert profiler.counter(sd.DENSIFY_COUNTER) == before
        out[pkg] = losses, {k: v.asnumpy()
                            for k, v in mod.get_params()[0].items()}
    return out[mt], out[mx]


@pytest.mark.parametrize("kv_kind", [None, "local"])
def test_linear_model_steps_match_jax(tmp_path, kv_kind):
    port, ref = _linear_runs(tmp_path, kv_kind)
    np.testing.assert_allclose(port[0], ref[0], rtol=1e-5, atol=1e-6)
    assert set(port[1]) == set(ref[1]) == {"weight", "bias"}
    for k in ref[1]:
        np.testing.assert_allclose(port[1][k], ref[1][k], rtol=1e-5,
                                   atol=1e-6)


def test_fm_fit_steps_match_jax(tmp_path):
    """The FM's ``_fit_step`` (the JAX package's one-call step, and the
    port's: its CSR is a static input of the step, so no step is left
    eager for it), 3 steps."""
    ex = _example("factorization_machine")
    path = str(tmp_path / "fm.libsvm")
    ex.synthetic_fm_libsvm(path, n=256, dim=200)
    out = {}
    for pkg in (mx, mt):
        it = pkg.io.LibSVMIter(data_libsvm=path, data_shape=(200,),
                               batch_size=64)
        sym = ex.fm_model(200, 8) if pkg is mx else cs.fm_symbol(mt, 200, 8)
        mod = pkg.mod.Module(sym, data_names=["data"],
                             label_names=["softmax_label"],
                             context=pkg.cpu())
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        if pkg is mx:
            mx.random.seed(0)
            mod.init_params()
            init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        else:
            mod.set_params(*mt.mod.params_from_jax(init, {}, sym))
        mod.init_optimizer(optimizer="adam",
                           optimizer_params=(("learning_rate", 0.05),))
        before = profiler.counter("sparse_eager_steps")
        calls = profiler.counter("program_calls")
        losses = []
        for b, _ in zip(it, range(3)):
            mod._fit_step(b)
            losses.append(float(mod.get_outputs()[0].asnumpy()))
        if pkg is mt:
            assert profiler.counter("sparse_eager_steps") - before == 0
            assert mod._cached_step is not None
            assert profiler.counter("program_calls") - calls == 3
        out[pkg] = losses, {k: v.asnumpy()
                            for k, v in mod.get_params()[0].items()}
    np.testing.assert_allclose(out[mt][0], out[mx][0], rtol=1e-5, atol=1e-6)
    for k in out[mx][1]:
        np.testing.assert_allclose(out[mt][1][k], out[mx][1][k], rtol=1e-5,
                                   atol=1e-5)


def test_data_writers_are_the_examples(tmp_path):
    """``test_utils.synthetic_libsvm``/``synthetic_fm_libsvm`` (the port's
    copies, which ``chip_smoke.py`` calls) write the examples' files."""
    for name, fn, mine in (
            ("sparse_linear_classification", "synthetic_libsvm",
             mt.test_utils.synthetic_libsvm),
            ("factorization_machine", "synthetic_fm_libsvm",
             mt.test_utils.synthetic_fm_libsvm)):
        theirs = str(tmp_path / (name + ".ref"))
        ours = str(tmp_path / (name + ".port"))
        getattr(_example(name), fn)(theirs, n=64)
        mine(ours, n=64)
        with open(theirs, "rb") as a, open(ours, "rb") as b:
            assert a.read() == b.read()
