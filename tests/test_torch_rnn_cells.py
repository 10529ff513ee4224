"""The PyTorch package's ``mx.rnn`` (symbolic cells, ``BucketSentenceIter``,
RNN checkpoints) and the ``LSTMBias``/``FusedRNN`` initializers against
the JAX package's, on the CPU.

Mirrors ``tests/test_rnn_package.py`` case for case: each graph is built
in both packages, bound with the same seeded fp64 arguments and run
forward; the arguments' names and shapes must agree and the outputs lie
within 1e-12 (the same ops in other summation orders; the readings are
near 1e-16).  The iterator must yield the JAX package's batches in its
order after ``random.seed`` in both; the initializers must draw the JAX
package's values bit for bit (both draw from ``random.host_rng()``); an
RNN checkpoint written here must load in the JAX package.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

TOL = dict(rtol=0, atol=1e-12)


@pytest.fixture(scope="module", autouse=True)
def x64_and_threads():
    prev = jax.config.jax_enable_x64, torch.get_num_threads()
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_enable_x64", prev[0])
    torch.set_num_threads(prev[1])


@pytest.fixture(autouse=True)
def own_names():
    with mx.name.NameManager(), mt.name.NameManager():
        yield


def run_both(build, shapes, seed=0):
    """Build with ``build(pkg)`` -> (outputs symbol, states) in each
    package, bind fp64 arguments drawn from ``seed`` and run forward:
    (the outputs of each, the number of states)."""
    results = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        outs, states = build(pkg)
        arg_shapes, _, _ = outs.infer_shape(**shapes)
        rng = np.random.RandomState(seed)
        names = outs.list_arguments()
        args = {n: pkg.nd.array(rng.randn(*s) * 0.5, ctx=ctx,
                                dtype="float64")
                for n, s in zip(names, arg_shapes)}
        out = outs.bind(ctx, args).forward()
        results.append((names, arg_shapes, [o.asnumpy() for o in out],
                        len(states)))
    (n0, s0, o0, k0), (n1, s1, o1, k1) = results
    assert (n0, s0, k0) == (n1, s1, k1)
    for a, b in zip(o0, o1):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, **TOL)
    return o1, k1


def test_rnn_cell_unroll_shapes():
    def build(pkg):
        cell = pkg.rnn.RNNCell(num_hidden=16, prefix="r_")
        return cell.unroll(3, pkg.sym.Variable("data"), merge_outputs=True)
    (out,), _ = run_both(build, {"data": (2, 3, 8)})
    assert out.shape == (2, 3, 16)


@pytest.mark.parametrize("cell,n_states", [("LSTMCell", 2), ("GRUCell", 1)])
def test_lstm_gru_unroll_and_states(cell, n_states):
    def build(pkg):
        c = getattr(pkg.rnn, cell)(12, prefix="c_")
        return c.unroll(4, pkg.sym.Variable("data"), merge_outputs=True)
    (out,), k = run_both(build, {"data": (3, 4, 6)})
    assert k == n_states and out.shape == (3, 4, 12)
    assert np.isfinite(out).all()


def test_sequential_and_residual_cells():
    def build(pkg):
        stack = pkg.rnn.SequentialRNNCell()
        stack.add(pkg.rnn.LSTMCell(8, prefix="s0_"))
        stack.add(pkg.rnn.ResidualCell(pkg.rnn.LSTMCell(8, prefix="s1_")))
        return stack.unroll(3, pkg.sym.Variable("data"), merge_outputs=True)
    (out,), k = run_both(build, {"data": (2, 3, 8)})
    assert out.shape == (2, 3, 8) and k == 4


def test_bidirectional_cell():
    def build(pkg):
        cell = pkg.rnn.BidirectionalCell(pkg.rnn.LSTMCell(8, prefix="fw_"),
                                         pkg.rnn.LSTMCell(8, prefix="bw_"))
        return cell.unroll(3, pkg.sym.Variable("data"), merge_outputs=True)
    (out,), _ = run_both(build, {"data": (2, 3, 5)})
    assert out.shape == (2, 3, 16)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
def test_fused_rnn_cell_unroll_and_unfuse(mode):
    def fused(pkg):
        cell = pkg.rnn.FusedRNNCell(10, num_layers=2, mode=mode,
                                    prefix="f_", get_next_state=True)
        return cell.unroll(5, pkg.sym.Variable("data"), layout="NTC",
                           merge_outputs=True)
    (out,), k = run_both(fused, {"data": (3, 5, 7)})
    assert out.shape == (3, 5, 10) and np.isfinite(out).all()
    assert k == (2 if mode == "lstm" else 1)

    def unfused(pkg):
        cell = pkg.rnn.FusedRNNCell(10, num_layers=2, mode=mode,
                                    prefix="f_")
        return cell.unfuse().unroll(5, pkg.sym.Variable("data"),
                                    merge_outputs=True)
    (out2,), _ = run_both(unfused, {"data": (3, 5, 7)})
    assert out2.shape == (3, 5, 10)


def test_fused_cell_matches_unfused_weights():
    """The packed vector in the op's layout (per layer: i2h W, h2h W, i2h
    b, h2h b) gives the unfused stack's outputs from the same weights,
    where the unfused LSTMCell's forget bias of 1 is moved into the packed
    i2h bias."""
    h, c, layers = 6, 4, 2
    data = np.random.RandomState(1).randn(3, 5, c)
    rng = np.random.RandomState(2)
    weights = {}
    for l in range(layers):
        width = c if l == 0 else h
        for name, shape in (("i2h_weight", (4 * h, width)),
                            ("h2h_weight", (4 * h, h)),
                            ("i2h_bias", (4 * h,)), ("h2h_bias", (4 * h,))):
            weights["f_l%d_%s" % (l, name)] = rng.randn(*shape) * 0.4
    packed = []
    for l in range(layers):
        for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
            w = weights["f_l%d_%s" % (l, name)].copy()
            if name == "i2h_bias":
                w[h:2 * h] += 1.0
            packed.append(w.ravel())
    fused = mt.rnn.FusedRNNCell(h, num_layers=layers, prefix="f_")
    x = mt.sym.Variable("data")
    outs = [fused.unroll(5, x, merge_outputs=True)[0],
            fused.unfuse().unroll(5, x, merge_outputs=True)[0]]
    args = [{"f_parameters": np.concatenate(packed)}, weights]
    got = []
    for sym, arg in zip(outs, args):
        arg = {k: mt.nd.array(v, ctx=mt.cpu(), dtype="float64")
               for k, v in arg.items()}
        arg["data"] = mt.nd.array(data, ctx=mt.cpu(), dtype="float64")
        got.append(sym.bind(mt.cpu(), arg).forward()[0].asnumpy())
    np.testing.assert_allclose(got[0], got[1], **TOL)


def test_dropout_and_zoneout_cells_build_the_same_graph():
    """DropoutCell and ZoneoutCell in predict mode: the JAX package's
    graph and outputs (training draws differ between the packages'
    generators)."""
    def build(pkg):
        stack = pkg.rnn.SequentialRNNCell()
        stack.add(pkg.rnn.ZoneoutCell(pkg.rnn.GRUCell(6, prefix="z_"),
                                      zoneout_outputs=0.3,
                                      zoneout_states=0.2))
        stack.add(pkg.rnn.DropoutCell(0.5, prefix="d_"))
        return stack.unroll(3, pkg.sym.Variable("data"), merge_outputs=True)
    (out,), _ = run_both(build, {"data": (2, 3, 4)})
    assert out.shape == (2, 3, 6)


def iterator_batches(pkg, sents, **kw):
    pkg.random.seed(11)
    it = pkg.rnn.BucketSentenceIter(sents, **kw)
    out = []
    for _ in range(2):
        for batch in it:
            out.append((batch.bucket_key, batch.data[0].asnumpy(),
                        batch.label[0].asnumpy(),
                        [tuple(d) for d in batch.provide_data]))
        it.reset()
    return out


def test_bucket_sentence_iter_contract():
    sents = [[1, 2, 3], [4, 5, 6, 7, 8], [1, 2], [3, 4, 5, 6]]
    it = mt.rnn.BucketSentenceIter(sents, batch_size=2, buckets=[4, 8],
                                   invalid_label=0)
    batch = it.next()
    assert batch.bucket_key in (4, 8)
    data, label = batch.data[0].asnumpy(), batch.label[0].asnumpy()
    assert data.shape == (2, batch.bucket_key)
    assert batch.data[0].context == mt.cpu()
    np.testing.assert_array_equal(label[:, :-1], data[:, 1:])


def test_bucket_sentence_iter_is_the_jax_packages():
    """Same seed, same batches in the same order, over two epochs, in both
    layouts."""
    rng = np.random.RandomState(0)
    sents = [list(rng.randint(1, 30, rng.randint(1, 13)))
             for _ in range(90)]
    for layout in ("NT", "TN"):
        kw = dict(batch_size=4, buckets=[4, 8, 12], invalid_label=0,
                  layout=layout)
        want, got = iterator_batches(mx, sents, **kw), \
            iterator_batches(mt, sents, **kw)
        assert len(got) == len(want) > 10
        for (k0, d0, l0, p0), (k1, d1, l1, p1) in zip(want, got):
            assert k0 == k1 and p0 == p1
            np.testing.assert_array_equal(d1, d0)
            np.testing.assert_array_equal(l1, l0)


def test_encode_sentences_grows_vocab():
    for pkg in (mx, mt):
        enc, vocab = pkg.rnn.encode_sentences([["a", "b"], ["b", "c"]],
                                              start_label=1)
        assert sorted(set(sum(enc, []))) == [1, 2, 3]
        assert set(vocab) >= {"a", "b", "c"}
    assert mt.rnn.encode_sentences([["x", "y", "x"]], invalid_label=0,
                                   start_label=1) == \
        mx.rnn.encode_sentences([["x", "y", "x"]], invalid_label=0,
                                start_label=1)


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.init.LSTMBias(forget_bias=2.5),
    lambda pkg: pkg.init.FusedRNN(pkg.init.Normal(0.3), 8, 2, "lstm"),
    lambda pkg: pkg.init.FusedRNN("uniform"),
    lambda pkg: pkg.init.FusedRNN(None),
], ids=["lstmbias", "fusedrnn-normal", "fusedrnn-name", "fusedrnn-default"])
def test_rnn_initializers_are_the_jax_packages(make):
    """Bit for bit against the JAX package's draws, through the name
    dispatch (a bias, a packed vector) and a variable's ``__init__``."""
    for name, shape in (("l_i2h_bias", (32,)), ("f_parameters", (96,))):
        got = []
        for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
            pkg.random.seed(3)
            arr = pkg.nd.zeros(shape, ctx=ctx)
            init = make(pkg)
            init(pkg.init.InitDesc(name), arr)
            attr = {"__init__": init.dumps()}
            second = pkg.nd.zeros(shape, ctx=ctx)
            pkg.init.Uniform()(pkg.init.InitDesc(name, attr), second)
            got.append((arr.asnumpy(), second.asnumpy(), init.dumps()))
        np.testing.assert_array_equal(got[1][0], got[0][0])
        np.testing.assert_array_equal(got[1][1], got[0][1])
        assert got[0][2] == got[1][2]


def test_lstm_bias_sets_the_forget_gate():
    arr = mt.nd.zeros((12,), ctx=mt.cpu())
    mt.init.LSTMBias(forget_bias=1.5)("x_bias", arr)
    np.testing.assert_array_equal(arr.asnumpy(),
                                  [0] * 3 + [1.5] * 3 + [0] * 6)


def test_rnn_checkpoint_crosses_packages(tmp_path):
    """``save_rnn_checkpoint`` here, ``load_rnn_checkpoint`` in the JAX
    package (and back), the packed vector unchanged; ``do_rnn_checkpoint``
    writes at its period."""
    cell = mt.rnn.FusedRNNCell(6, num_layers=2, prefix="f_")
    out, _ = cell.unroll(3, mt.sym.Variable("data"), merge_outputs=True)
    rng = np.random.RandomState(4)
    size = mt.ops.nn.rnn_param_size(2, 5, 6, "lstm")
    args = {"f_parameters": mt.nd.array(rng.randn(size), ctx=mt.cpu())}
    prefix = str(tmp_path / "lm")
    mt.rnn.save_rnn_checkpoint(cell, prefix, 3, out, args, {})
    ref_cell = mx.rnn.FusedRNNCell(6, num_layers=2, prefix="f_")
    sym, ref_args, _ = mx.rnn.load_rnn_checkpoint(ref_cell, prefix, 3)
    assert sym.list_arguments() == out.list_arguments()
    np.testing.assert_array_equal(ref_args["f_parameters"].asnumpy(),
                                  args["f_parameters"].asnumpy())
    mx.rnn.save_rnn_checkpoint(ref_cell, prefix + "-ref", 1, sym, ref_args,
                               {})
    _, back, _ = mt.rnn.load_rnn_checkpoint(cell, prefix + "-ref", 1)
    np.testing.assert_array_equal(back["f_parameters"].asnumpy(),
                                  args["f_parameters"].asnumpy())
    save = mt.rnn.do_rnn_checkpoint(cell, prefix + "-cb", period=2)
    for epoch in range(4):
        save(epoch, out, args, {})
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("lm-cb-0")) == \
        ["lm-cb-0002.params", "lm-cb-0004.params"]
