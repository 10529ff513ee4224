"""The rank side of the parallel tier's CPU tests: functions that
``test_utils.RankPool`` runs on every rank of a gloo group.

Each builds its mesh (a collective call: every rank builds the same
meshes in the same order), runs the port on this rank's blocks and
returns numpy results; the tests compare them with the JAX package.  This
module imports neither JAX nor the JAX package, as the ranks must not
(``tests/test_torch_package.py`` checks it).
"""
import importlib
import os
import sys
import time

import numpy as np
import torch

from mxnet_tpu_torch.models import moe as tmoe
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.parallel import collective as col
from mxnet_tpu_torch.parallel import mesh as mm
from mxnet_tpu_torch.parallel import multihost, pipeline, zero
from mxnet_tpu_torch import profiler

# the package's ``ring_attention`` attribute is the function
ring = importlib.import_module("mxnet_tpu_torch.parallel.ring_attention")

FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu", "ml_dtypes")


def _mesh(shape, n=None):
    ranks = None if n is None else list(range(n))
    return mm.make_mesh(shape, ranks=ranks, device="cpu")


# -- the rank worker and the mesh ---------------------------------------------

def forbidden_modules():
    """The JAX modules loaded in this rank's process (must be none)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def hang(rank):
    """Rank ``rank`` sleeps past any test's timeout; the others return."""
    if multihost.rank() == rank:
        time.sleep(600)
    return multihost.rank()


def fail(rank):
    if multihost.rank() == rank:
        raise ValueError("rank %d fails on purpose" % rank)
    return multihost.rank()


def topology():
    return mm.topology()


def mesh_shapes(case):
    """The mesh a ``test_mesh.py`` case builds: its shape, or the name of
    the exception building it raised."""
    try:
        if case == "single":
            m = mm.make_mesh({"data": -1}, ranks=[0], device="cpu")
        elif case == "minus_one":
            m = _mesh({"data": -1, "model": 2})
        elif case == "minus_one_indivisible":
            m = _mesh({"data": -1, "model": 3})
        elif case == "auto":
            m = mm.auto_mesh(("data", "model"), device="cpu")
        elif case == "multihost_faked":
            m = mm.multihost_mesh({"data": -1}, n_hosts=2, device="cpu")
        elif case == "multihost_uneven":
            m = mm.multihost_mesh({"data": -1}, n_hosts=3, device="cpu")
        elif case == "multihost_collision":
            m = mm.multihost_mesh({"host": 2}, n_hosts=2, device="cpu")
        elif case == "multihost_live":
            m = mm.multihost_mesh(device="cpu")
        else:
            raise KeyError(case)
    except ValueError as e:
        return type(e).__name__
    return {"names": list(m.axis_names), "shape": dict(m.shape),
            "coordinate": m.coordinate}


def mesh_env(shape, span):
    """``mesh_from_env`` under ``MXNET_MESH_SHAPE`` / ``_SPAN_HOSTS``."""
    old = {k: os.environ.get(k) for k in ("MXNET_MESH_SHAPE",
                                          "MXNET_MESH_SPAN_HOSTS")}
    try:
        os.environ["MXNET_MESH_SHAPE"] = shape
        os.environ["MXNET_MESH_SPAN_HOSTS"] = span
        mm.refresh_from_env()
        m = mm.mesh_from_env(device="cpu")
        return list(m.axis_names), dict(m.shape)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        mm.refresh_from_env()


def default_mesh_precedence():
    """``test_mesh.py::test_default_mesh_precedence``: the scope beats the
    environment, which beats every rank balanced."""
    old = os.environ.get("MXNET_MESH_SHAPE")
    try:
        os.environ["MXNET_MESH_SHAPE"] = "data=2"
        mm.refresh_from_env()
        scoped = mm.auto_mesh(("data", "model"), device="cpu")
        with mm.using_mesh(scoped):
            in_scope = mm.default_mesh(device="cpu") is scoped
        from_env = dict(mm.default_mesh(device="cpu").shape)
        del os.environ["MXNET_MESH_SHAPE"]
        mm.refresh_from_env()
        auto = dict(mm.default_mesh(("data",), device="cpu").shape)
        return in_scope, from_env, auto
    finally:
        if old is not None:
            os.environ["MXNET_MESH_SHAPE"] = old
        mm.refresh_from_env()


def filter_spec():
    m = _mesh({"data": -1})
    return (mm.filter_spec(("data", "model", "seq"), m),
            mm.filter_spec(("model",), m), mm.filter_spec(("data",), None))


def shard_put_round_trip(host):
    """``test_named_sharding_and_shard_put_round_trip``: blocks, their
    specs and the gathered arrays."""
    m = mm.auto_mesh(("data", "model"), device="cpu")
    sh = mm.named_sharding(m, ("data", "seq"))
    blk = mm.shard_put(host, sh)
    blk2 = mm.shard_put(host, m, spec=("data", None))
    rep = mm.shard_put(host, mm.replicated(m))
    return {"spec": sh.spec, "block": blk.numpy(), "whole": mm.shard_get(
        blk, sh), "whole2": mm.shard_get(blk2, m, ("data", None)),
        "rep_spec": mm.replicated(m).spec, "rep": mm.shard_get(rep, m)}


def shard_map_psum():
    m = _mesh({"data": -1})
    n = m.shape["data"]
    x = np.arange(4 * n, dtype=np.float32)
    fn = mm.shard_map(lambda a: col.psum(a.sum(), "data") * torch.ones_like(a),
                      m, in_specs=(("data",),), out_specs=("data",))
    return mm.shard_get(fn(mm.shard_put(x, m, ("data",))), m, ("data",)), x


def shard_map_scope():
    """The scope's mesh serves ``shard_map``; without one it raises."""
    m = _mesh({"data": -1})
    with mm.using_mesh(m):
        fn = mm.shard_map(lambda a: a * 2.0, in_specs=(("data",),),
                          out_specs=("data",))
    out = fn(torch.ones(1)).numpy()
    try:
        mm.shard_map(lambda a: a, in_specs=(("data",),),
                     out_specs=("data",))
        raised = None
    except ValueError as e:
        raised = type(e).__name__
    return out, raised


# -- collectives ----------------------------------------------------------------

def collectives(x, w_all_gather):
    """``test_parallel.py::test_collectives_shard_map``'s collectives and
    the rest of the surface over a ring ``x`` of 4 ranks, with each
    one's gradient of ``sum(out * w)``: ``{name: (out, grad)}`` gathered
    over the axis."""
    m = _mesh({"x": 4})
    spec = ("x",)
    i = m.coordinate["x"]
    w = np.arange(1.0, 5.0, dtype=np.float32)
    res = {}

    def run(name, f, weights, out_spec=spec):
        blk = mm.shard_put(x, m, spec).requires_grad_()
        with mm.using_mesh(m):
            out = f(blk)
            wb = mm.shard_put(weights, m, out_spec)
            (out * wb).sum().backward()
            res[name] = (mm.shard_get(out, m, out_spec),
                         mm.shard_get(blk.grad, m, spec))
    run("psum", lambda s: col.psum(s, "x"), w)
    run("pmean", lambda s: col.pmean(s, "x"), w)
    run("ppermute", lambda s: col.ppermute_shift(s, "x", 1), w)
    run("ppermute_back", lambda s: col.ppermute_shift(s, "x", -1), w)
    run("all_gather", lambda s: col.all_gather(s, "x", axis=0),
        w_all_gather)
    run("reduce_scatter", lambda s: col.reduce_scatter(s.repeat(4), "x"), w)
    run("all_to_all", lambda s: col.all_to_all(
        s.repeat(4) * (torch.arange(4.0) + 1), "x", 0, 0), w_all_gather)
    with mm.using_mesh(m):
        res["pmax"] = float(col.pmax(torch.tensor([float(i)]), "x"))
        res["axis_index"], res["axis_size"] = (col.axis_index("x"),
                                               col.axis_size("x"))
    res["host_allreduce"] = col.host_allreduce(
        [torch.full((2,), float(k)) for k in range(3)]).numpy()
    col.barrier()
    return res


# -- ring attention -----------------------------------------------------------

def ring_attention(q, k, v, do, causal):
    """The ring over ``seq`` (every rank), in the forward and the
    gradients, gathered; and this rank's ``local_attention`` reference on
    the whole sequence."""
    m = _mesh({"seq": -1})
    spec = (None, None, "seq", None)
    qb, kb, vb = (mm.shard_put(t, m, spec).requires_grad_()
                  for t in (q, k, v))
    before = profiler.counter("collective_p2p")
    out = ring.ring_attention_sharded(qb, kb, vb, m, causal=causal)
    out.backward(mm.shard_put(do, m, spec))
    p2p = profiler.counter("collective_p2p") - before
    tq, tk, tv = (torch.as_tensor(t).requires_grad_() for t in (q, k, v))
    ref = ring.local_attention(tq, tk, tv, causal=causal)
    ref.backward(torch.as_tensor(do))
    got = [mm.shard_get(t, m, spec) for t in (out, qb.grad, kb.grad,
                                               vb.grad)]
    want = [t.detach().numpy() for t in (ref, tq.grad, tk.grad, tv.grad)]
    return got, want, p2p


# -- the LM on a data x seq x model mesh ---------------------------------------

SMALL = dict(vocab=32, d_model=16, n_heads=4, d_ff=32, n_layers=2,
             max_len=16)
LM_MESH = {"data": 2, "seq": 2, "model": 2}


def _gather_params(params, cfg, m):
    return {n: mm.shard_get(t, m, tt.param_spec(n, cfg, m))
            for n, t in params.items()}


def lm_forward(np_params, tokens, shape=None):
    """This rank's logits from the JAX package's params, gathered."""
    cfg = tt.TransformerLMConfig(**SMALL)
    m = _mesh(shape or LM_MESH)
    params = tt.params_from_jax(np_params, cfg, mesh=m)
    tok, _ = tt.place_batch(tokens, tokens, mesh=m)
    logits = tt.transformer_forward(params, tok, cfg, mesh=m)
    return mm.shard_get(logits, m, ("data", "seq", None))


def lm_train(np_params, tokens, labels, steps, lr, builder, momentum=0.9,
             shape=None):
    """``steps`` steps of ``make_train_step`` ("plain") or
    ``make_train_step_zero1`` ("zero1") on the mesh: the losses, the
    gathered params, and for zero1 the gathered momenta, each momentum's
    shape on this rank and the ZeRO counters' arithmetic."""
    cfg = tt.TransformerLMConfig(**SMALL)
    m = _mesh(shape or LM_MESH)
    params = tt.params_from_jax(np_params, cfg, mesh=m)
    tok, lab = tt.place_batch(tokens, labels, mesh=m)
    out = {"losses": []}
    if builder == "plain":
        step = tt.make_train_step(cfg, lr=lr, mesh=m)
        for _ in range(steps):
            params, loss = step(params, tok, lab)
            out["losses"].append(float(loss))
    else:
        step, momenta = tt.make_train_step_zero1(cfg, params, lr=lr,
                                                 momentum=momentum, mesh=m)
        for _ in range(steps):
            params, momenta, loss = step(params, momenta, tok, lab)
            out["losses"].append(float(loss))
        n = m.shape.get("data", 1)
        sharded = {nm: tuple(mt.shape) != tuple(params[nm].shape)
                   for nm, mt in momenta.items()}
        out["momentum_shapes"] = {nm: tuple(mt.shape)
                                  for nm, mt in momenta.items()}
        out["param_shapes"] = {nm: tuple(p.shape) for nm, p in params.items()}
        out["momenta"] = {
            nm: mm.shard_get(mt, m, ("data",) + (None,) * (mt.dim() - 1)
                             if sharded[nm] else tt.param_spec(nm, cfg, m))
            for nm, mt in momenta.items()}
        out["momentum_bytes"] = sum(t.numel() * t.element_size()
                                    for t in momenta.values())
        out["state_bytes"] = zero.state_bytes(
            [(tuple(params[nm].shape), "float32", sharded[nm])
             for nm in params], n)
    out["params"] = _gather_params(params, cfg, m)
    return out


def zero_bitwise(shapes, seed):
    """The update of ``zero.sharded_update`` over a data group of every
    rank, on one reduced gradient (rank 0 holds it, the others zeros, so
    the sum is exact), against the replicated update of the same
    gradient: the bits that differ, weight by weight."""
    m = _mesh({"data": -1})
    group = m.group("data")
    rng = np.random.RandomState(seed)
    lr, mom = 0.1, 0.9
    ps = [torch.as_tensor(rng.randn(*s).astype(np.float32)) for s in shapes]
    gs = [torch.as_tensor(rng.randn(*s).astype(np.float32)) for s in shapes]
    ms0 = [torch.as_tensor(rng.randn(*s).astype(np.float32)) for s in shapes]

    def momentum_sgd(ps, gs, ms, hyper):
        torch._foreach_mul_(ms, mom)
        torch._foreach_add_(ms, gs)
        torch._foreach_sub_(ps, torch._foreach_mul(ms, lr))
        return ps, ms
    mine = [g if multihost.rank() == 0 else torch.zeros_like(g) for g in gs]
    n = m.shape["data"]
    sharded = [zero.zero1_update_spec(s, True, n) for s in shapes]
    ms = [zero.sharded_state(x.clone(), group) if sh else x.clone()
          for x, sh in zip(ms0, sharded)]
    new_p, new_m = zero.sharded_update(momentum_sgd, [p.clone() for p in ps],
                                       mine, ms, {}, group)
    ref_p, ref_m = momentum_sgd([p.clone() for p in ps], gs,
                                [x.clone() for x in ms0], {})
    rows = [zero._rows(group, s[0]) if sh else slice(None)
            for s, sh in zip(shapes, sharded)]
    return {"sharded": sharded,
            "params_differ": [int((a != b).sum()) for a, b in
                              zip(new_p, ref_p)],
            "momenta_differ": [int((a != b[r]).sum()) for a, b, r in
                               zip(new_m, ref_m, rows)]}


def zero_placement(cases):
    """``zero1_axis_mesh``, ``update_sharding`` and
    ``shard_state_tree_spec`` for ``cases`` of (weight shape, replicated,
    state leaf shape): whether the update shards, and where each state
    leaf goes ("update" or "replicated")."""
    m = zero.zero1_axis_mesh(4, device="cpu")
    out = {"shape": dict(m.shape), "decisions": []}
    for shape, rep, leaf in cases:
        upd = zero.update_sharding(m, shape, "zero", rep)
        assert upd is None or upd is m.group("zero")
        place = zero.shard_state_tree_spec(leaf, shape, upd, "replicated")
        out["decisions"].append((upd is not None,
                                 "update" if place is upd and upd is not None
                                 else place))
    return out


# -- MoE and the pipeline -------------------------------------------------------

def moe(np_params, x, shape, capacity_factor, dy):
    """``moe_ffn`` on the mesh ``shape`` (experts over ``model``) and
    unsharded, with the gradients of ``sum(out * dy)``."""
    m = _mesh(shape)
    specs = {n: mm.filter_spec(spec, m) for n, (_, spec) in
             tmoe.moe_param_specs(1, 1, 1).items()}
    res = {}
    for mesh in (m, None):
        if mesh is None:
            params = {n: torch.as_tensor(a).requires_grad_()
                      for n, a in np_params.items()}
        else:
            params = {n: mm.shard_put(a, m, specs[n]).requires_grad_()
                      for n, a in np_params.items()}
        xt = torch.as_tensor(x).requires_grad_()
        out = tmoe.moe_ffn(xt, params, capacity_factor=capacity_factor,
                           mesh=mesh)
        (out * torch.as_tensor(dy)).sum().backward()
        res["whole" if mesh is None else "sharded"] = {
            "out": out.detach().numpy(), "dx": xt.grad.numpy(),
            "grads": {n: (p.grad.numpy() if mesh is None else
                          mm.shard_get(p.grad, m, specs[n]))
                      for n, p in params.items()},
            "experts_here": int(params["expert_w1"].shape[0])}
    return res


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_run(np_params, x, n_stages, n_micro, target=None, steps=0,
                 lr=0.5):
    """``pipeline_apply`` over ``pipe`` (the first ``n_stages`` ranks):
    the output and the gradients of ``sum(out ** 2)``, gathered; with
    ``steps``, the losses of that many SGD steps on the mean squared error
    against ``target``.  Ranks outside the mesh return None."""
    m = mm.make_mesh({"pipe": n_stages}, ranks=list(range(n_stages)),
                     device="cpu")
    if m.coordinate is None:
        return None
    params = {n: mm.shard_put(a, m, ("pipe",)).requires_grad_()
              for n, a in np_params.items()}
    xt = torch.as_tensor(x)
    if steps:
        losses = []
        tgt = torch.as_tensor(target)
        for _ in range(steps):
            out = pipeline.pipeline_apply(stage_fn, params, xt, m, n_micro)
            loss = ((out - tgt) ** 2).mean()
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for p, g in zip(params.values(), grads):
                    p -= lr * g
            losses.append(float(loss))
        return losses
    before = profiler.counter("collective_p2p")
    out = pipeline.pipeline_apply(stage_fn, params, xt, m, n_micro)
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(),
            "grads": {n: mm.shard_get(p.grad, m, ("pipe",))
                      for n, p in params.items()},
            "p2p": profiler.counter("collective_p2p") - before}
