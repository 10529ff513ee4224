"""Causal transformer LM in PyTorch: inference and the train steps.

Counterpart of ``mxnet_tpu/models/transformer.py`` on one device: the same
parameter names, shapes and layouts (``wq`` [d_model, n_heads, hd], ``wo``
[n_heads, hd, d_model]), the same pre-norm blocks with RMSNorm and the
tanh-approximated GELU, the same mean next-token NLL, and the same train
steps: plain SGD (:func:`make_train_step`) and SGD with momentum through
the ZeRO-1 update (:func:`make_train_step_zero1`, one rank).  Attention
goes through :func:`mxnet_tpu_torch.ops.flash_attention`, forward and
backward: the CUDA kernels for a tensor on the card, at every sequence
length, and the plain versions on the CPU.  On the card each train step
is one replay of a captured CUDA graph (``capture``).

With ``mesh=`` (a ``parallel.mesh.Mesh`` over the ranks, this package's
SPMD idiom) the same functions run the JAX package's data x sequence x
tensor parallel path (``transformer.py:112-248``) on this rank's blocks:
the parameters at the JAX package's Megatron layout over ``model``
(``_param_specs``, ``:48-78``; each rank holds its shard of the one
global draw), the batch over ``data`` and ``seq_axis``.  Attention is the
ring (``parallel.ring_attention``) with more than one ``seq`` rank, and
otherwise the flash kernel on the rank's heads, as the JAX package's
``shard_map`` runs it (``:160-173``); ``pos_embed`` is offset by the
rank's ``seq`` coordinate; Megatron's "f" and "g" (``collective``) sum
the activations' partial products and gradients over ``model``; the loss
is the global token mean, and the gradients are summed over ``data`` and
``seq``.  The sharded steps run eagerly: a gloo collective is a host
call, which a CUDA graph cannot hold.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..base import MXNetError
from .. import capture
from ..context import as_device
from ..ops.attention import flash_attention
from ..parallel import collective, zero
from ..parallel import mesh as mesh_mod
from ..parallel.ring_attention import ring_attention

__all__ = ["TransformerLMConfig", "TransformerLM", "init_transformer_params",
           "params_from_jax", "transformer_forward", "nll_from_logits",
           "lm_nll", "make_train_step", "make_train_step_zero1",
           "place_batch"]


@dataclasses.dataclass(frozen=True)
class TransformerLMConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    d_ff: int = 256
    n_layers: int = 2
    max_len: int = 128
    dtype: torch.dtype = torch.float32


def _param_specs(cfg):
    """name -> (shape, spec): the JAX package's ``_param_specs``, Megatron
    tensor parallelism over ``model``."""
    hd = cfg.d_model // cfg.n_heads
    specs = {
        "embed": ((cfg.vocab, cfg.d_model), (None, None)),
        "pos_embed": ((cfg.max_len, cfg.d_model), (None, None)),
        "out_norm_scale": ((cfg.d_model,), (None,)),
        "out_proj": ((cfg.d_model, cfg.vocab), (None, None)),
    }
    for i in range(cfg.n_layers):
        pre = "layer%d_" % i
        specs.update({
            # QKV/out projections: heads sharded over 'model'
            pre + "wq": ((cfg.d_model, cfg.n_heads, hd), (None, "model", None)),
            pre + "wk": ((cfg.d_model, cfg.n_heads, hd), (None, "model", None)),
            pre + "wv": ((cfg.d_model, cfg.n_heads, hd), (None, "model", None)),
            pre + "wo": ((cfg.n_heads, hd, cfg.d_model), ("model", None, None)),
            # MLP: hidden sharded over 'model' (column-, then row-parallel)
            pre + "w1": ((cfg.d_model, cfg.d_ff), (None, "model")),
            pre + "b1": ((cfg.d_ff,), ("model",)),
            pre + "w2": ((cfg.d_ff, cfg.d_model), ("model", None)),
            pre + "norm1_scale": ((cfg.d_model,), (None,)),
            pre + "norm2_scale": ((cfg.d_model,), (None,)),
        })
    return specs


def _param_shapes(cfg):
    """name -> global shape, as the JAX package's ``_param_specs`` names
    them."""
    return {n: shape for n, (shape, _) in _param_specs(cfg).items()}


def param_spec(name, cfg, mesh):
    """The spec of parameter ``name`` on ``mesh`` (its axes the mesh lacks
    dropped)."""
    return mesh_mod.filter_spec(_param_specs(cfg)[name][1], mesh)


def _place(params, cfg, mesh):
    """Global params -> this rank's shards (``params`` itself without a
    mesh)."""
    if mesh is None:
        return params
    return {n: mesh_mod.shard_put(t, mesh, param_spec(n, cfg, mesh))
            for n, t in params.items()}


def _device(device, mesh):
    return mesh.device if mesh is not None else as_device(device)


def init_transformer_params(generator, cfg, device=None, mesh=None):
    """Random params: ones for norm scales, zeros for ``b1``, and
    N(0, 1/fan_in) elsewhere, where fan-in is the contracted dims (the
    leading axis, all but the last for ``wo``).  ``generator`` is a
    ``torch.Generator`` on ``device`` (default: the first CUDA card), or
    on ``mesh``'s device: then every rank draws the same global params
    from it and keeps its shard."""
    dev = _device(device, mesh)
    params = {}
    for name, shape in sorted(_param_shapes(cfg).items()):
        if name.endswith("_scale"):
            t = torch.ones(shape, dtype=cfg.dtype, device=dev)
        elif name.endswith("b1"):
            t = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        else:
            fan_in = (int(np.prod(shape[:-1])) if name.endswith("wo")
                      else shape[0])
            t = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=dev)
            t = (t * (1.0 / math.sqrt(max(fan_in, 1)))).to(cfg.dtype)
        params[name] = t
    return _place(params, cfg, mesh)


def params_from_jax(np_params, cfg, device=None, mesh=None):
    """The JAX package's ``{name: array}`` params (global arrays) as this
    package's tensors: same names, shapes and layouts, in ``cfg.dtype``;
    with ``mesh``, this rank's shards of them."""
    dev = _device(device, mesh)
    shapes = _param_shapes(cfg)
    if set(np_params) != set(shapes):
        raise MXNetError("params_from_jax: names differ from the config: "
                         "missing %s, unexpected %s"
                         % (sorted(set(shapes) - set(np_params)),
                            sorted(set(np_params) - set(shapes))))
    params = {}
    for name, shape in shapes.items():
        a = np.asarray(np_params[name])
        if a.shape != shape:
            raise MXNetError("params_from_jax: %s has shape %s, config wants %s"
                             % (name, a.shape, shape))
        # bfloat16 numpy arrays (ml_dtypes) have no torch counterpart in
        # from_numpy; widening to fp32 first is exact
        if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        params[name] = torch.tensor(a).to(device=dev, dtype=cfg.dtype)
    return _place(params, cfg, mesh)


def _rmsnorm(x, scale):
    # variance in fp32; normalise, cast back to x's dtype, then scale
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def _causal_attn_local(q, k, v):
    # the einsum views (strides (S*H*D, D, H*D, 1)) go to the kernel as
    # they are: it reads them through their strides
    return flash_attention(q, k, v, causal=True)


def _axis(mesh, name):
    """``name`` where ``mesh`` has it with more than one rank, else None."""
    return name if mesh.shape.get(name, 1) > 1 else None


def _sharded_forward(params, tokens, cfg, mesh, seq_axis):
    """This rank's logits block [B/data, S/seq, vocab] (whole over
    ``model``) from its token block, with ``mesh`` bound."""
    b, s = tokens.shape
    n_seq = mesh.shape.get(seq_axis, 1)
    if s * n_seq > cfg.max_len:
        raise MXNetError("sequence length %d exceeds max_len %d"
                         % (s * n_seq, cfg.max_len))
    model = _axis(mesh, "model")
    off = s * mesh.coordinate.get(seq_axis, 0)
    x = params["embed"][tokens] + params["pos_embed"][off:off + s][None]

    def enter(h):
        return collective.copy_to_axis(h, model) if model else h

    def leave(h):
        return collective.reduce_from_axis(h, model) if model else h
    for i in range(cfg.n_layers):
        pre = "layer%d_" % i
        h = enter(_rmsnorm(x, params[pre + "norm1_scale"]))
        q = torch.einsum("bsd,dhk->bhsk", h, params[pre + "wq"])
        k = torch.einsum("bsd,dhk->bhsk", h, params[pre + "wk"])
        v = torch.einsum("bsd,dhk->bhsk", h, params[pre + "wv"])
        if n_seq > 1:
            o = ring_attention(q, k, v, seq_axis, causal=True)
        else:
            o = _causal_attn_local(q, k, v)
        x = x + leave(torch.einsum("bhsk,hkd->bsd", o, params[pre + "wo"]))
        h = enter(_rmsnorm(x, params[pre + "norm2_scale"]))
        h = F.gelu(h @ params[pre + "w1"] + params[pre + "b1"],
                   approximate="tanh")
        x = x + leave(h @ params[pre + "w2"])
    x = _rmsnorm(x, params["out_norm_scale"])
    return x @ params["out_proj"]


def transformer_forward(params, tokens, cfg, mesh=None, seq_axis="seq"):
    """Causal LM forward: tokens [B, S] int -> logits [B, S, vocab], on the
    device the params live on.  With ``mesh``, ``params`` and ``tokens``
    are this rank's shards and blocks, and so are the logits (whole over
    ``model``)."""
    if mesh is not None:
        with mesh_mod.using_mesh(mesh):
            return _sharded_forward(params, tokens, cfg, mesh, seq_axis)
    b, s = tokens.shape
    if s > cfg.max_len:
        raise MXNetError("sequence length %d exceeds max_len %d"
                         % (s, cfg.max_len))
    x = params["embed"][tokens] + params["pos_embed"][:s][None, :, :]
    for i in range(cfg.n_layers):
        pre = "layer%d_" % i
        h = _rmsnorm(x, params[pre + "norm1_scale"])
        q = torch.einsum("bsd,dhk->bhsk", h, params[pre + "wq"])
        k = torch.einsum("bsd,dhk->bhsk", h, params[pre + "wk"])
        v = torch.einsum("bsd,dhk->bhsk", h, params[pre + "wv"])
        o = _causal_attn_local(q, k, v)
        x = x + torch.einsum("bhsk,hkd->bsd", o, params[pre + "wo"])
        h = _rmsnorm(x, params[pre + "norm2_scale"])
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h @ params[pre + "w1"] + params[pre + "b1"],
                   approximate="tanh")
        x = x + h @ params[pre + "w2"]
    x = _rmsnorm(x, params["out_norm_scale"])
    return x @ params["out_proj"]


def nll_from_logits(logits, labels):
    """Mean NLL in fp32 of ``labels`` [B, S] under ``logits`` [B, S, V]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])
    return nll.mean()


def lm_nll(params, tokens, labels, cfg):
    """Mean next-token NLL in fp32 (the JAX package's ``_lm_loss_fn``
    value, without a gradient)."""
    return nll_from_logits(transformer_forward(params, tokens, cfg), labels)


def _lm_loss_fn(cfg):
    """Mean next-token NLL in fp32: the loss of both train steps."""

    def loss_of(params, tokens, labels):
        return nll_from_logits(transformer_forward(params, tokens, cfg),
                               labels)

    return loss_of


def _sharded_loss_fn(cfg, mesh, seq_axis):
    """The global token mean of the NLL in fp32, on every rank (called with
    ``mesh`` bound): each rank's sum over its block over the global count,
    summed over ``data`` and ``seq`` by Megatron's "g", so each rank's
    gradient is that of its own block's share."""
    axes = tuple(a for a in ("data", seq_axis) if _axis(mesh, a))
    blocks = mesh.shape.get("data", 1) * mesh.shape.get(seq_axis, 1)

    def loss_of(params, tokens, labels):
        logits = _sharded_forward(params, tokens, cfg, mesh, seq_axis)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels.long()[..., None])
        local = nll.sum() / (nll.numel() * blocks)
        return collective.reduce_from_axis(local, axes) if axes else local

    return loss_of


def _grads_summed(grads, mesh, axes):
    """``grads`` summed over the mesh's ``axes``: one all-reduce an axis
    of them all, flattened."""
    axes = [a for a in axes if _axis(mesh, a)]
    if not axes:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    for a in axes:
        flat = collective._all_reduce(flat, mesh.group(a))
    return [c.view_as(g) for c, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def _sharded_loss_and_grads(cfg, mesh, seq_axis, axes):
    """``(params, tokens, labels) -> (loss, grads)`` on the mesh, the
    gradients summed over ``axes``."""
    loss_of = _sharded_loss_fn(cfg, mesh, seq_axis)

    def run(params, tokens, labels):
        tokens, labels = _on_device(mesh.device, params, tokens, labels)
        with mesh_mod.using_mesh(mesh):
            loss, grads = _loss_and_grads(loss_of, params, tokens, labels)
            return loss, _grads_summed(grads, mesh, axes)
    return run


def _loss_and_grads(loss_of, params, tokens, labels):
    """The loss and the gradient of every parameter (in ``params``'
    order), through torch autograd and so through the attention kernels'
    backward."""
    leaves = [p.detach().requires_grad_() for p in params.values()]
    with torch.enable_grad():
        loss = loss_of(dict(zip(params, leaves)), tokens, labels)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def _on_device(dev, params, tokens, labels):
    for name, p in params.items():
        if p.device != dev:
            raise MXNetError("train step on %s: param %s lies on %s"
                             % (dev, name, p.device))
    return tokens.to(dev), labels.to(dev)


def _run_step(programs, body, buffers, tokens, labels):
    """``body(tokens, labels) -> [loss]``, updating ``buffers`` in place:
    eagerly on the CPU (or inside ``capture.eager()``), else one replay of
    its captured program, keyed on the batch's shape, with the tokens and
    labels copied into the program's static inputs."""
    graph = capture.graph_for(tokens.device)
    if graph is None:
        return body(tokens, labels)
    prog = programs.program("lm_step", graph, tokens.device, lambda: [body],
                            [tokens, labels], buffers)
    return prog.replay(0, [tokens, labels])


def _sgd(ps, grads, lr):
    # lr * g rounded to the param's dtype, then subtracted: the JAX
    # package's order of operations
    torch._foreach_sub_(ps, torch._foreach_mul(
        [g.to(p.dtype) for p, g in zip(ps, grads)], lr))


def make_train_step(cfg, lr=0.1, device=None, mesh=None, seq_axis="seq"):
    """The train step ``step(params, tokens, labels) -> (new_params,
    loss)``: the gradients of the mean next-token NLL, then
    ``p - lr * g`` for every parameter, as the JAX package's
    ``make_train_step`` on one device.  ``device`` (default: the first
    CUDA card) is where the params must lie; tokens and labels are moved
    there.  The update is in place, so ``new_params`` is ``params``: the
    JAX step donates them, so callers already treat the old dict as
    consumed.  On the card the step is one replay of a captured program
    (``capture``), as the JAX step is one jitted program; the loss comes
    back as a copy.  With ``mesh`` the params, tokens and labels are this
    rank's shards and blocks, the loss the global one, and the step runs
    eagerly (one ``program_calls``)."""
    if mesh is not None:
        run = _sharded_loss_and_grads(cfg, mesh, seq_axis, ("data", seq_axis))

        def sharded_step(params, tokens, labels):
            loss, grads = run(params, tokens, labels)
            with torch.no_grad():
                _sgd(list(params.values()), grads, lr)
            return params, loss
        return mesh_mod.jit_sharded(sharded_step, "transformer_train_step")
    dev = as_device(device)
    loss_of = _lm_loss_fn(cfg)
    programs = capture.StepCache("make_train_step")

    def step(params, tokens, labels):
        tokens, labels = _on_device(dev, params, tokens, labels)
        ps = list(params.values())

        def body(tokens, labels):
            loss, grads = _loss_and_grads(loss_of, params, tokens, labels)
            with torch.no_grad():
                _sgd(ps, grads, lr)
            return [loss]
        (loss,) = _run_step(programs, body, ps, tokens, labels)
        return params, loss

    return step


def make_train_step_zero1(cfg, params, lr=0.1, momentum=0.9, group=None,
                          mesh=None, seq_axis="seq"):
    """SGD with momentum through the ZeRO-1 update (``parallel.zero``), as
    the JAX package's ``make_train_step_zero1``: ``m = momentum * m + g``,
    then ``p = p - lr * m``.  Returns ``(step, momenta)``, with
    ``step(params, momenta, tokens, labels) -> (new_params, new_momenta,
    loss)`` on the device the params lie on, updating both dicts in place.

    Without ``mesh``, ``group`` is None or a process group of one rank:
    no update shards, the momenta are zeros like each param, and on the
    card the step is one replay of a captured program, as
    :func:`make_train_step`.  With ``mesh``, the data group is its
    ``data`` axis: the momentum of each weight whose update shards there
    (``zero.zero1_update_spec``: whole on every rank, leading dim
    divisible) holds this rank's rows only, the gradients are summed over
    ``seq_axis`` and the update reduce-scatters them over ``data``
    (``zero.sharded_update``); the step runs eagerly."""
    if mesh is not None:
        if group is not None:
            raise MXNetError("make_train_step_zero1: pass mesh= or group=, "
                             "not both (the mesh's data axis is the group)")
        group = mesh.group("data") if "data" in mesh.axis_names else None
    n = zero.group_size(group)
    if mesh is None and n > 1:
        raise MXNetError("make_train_step_zero1: a data group of %d ranks "
                         "comes with mesh= (the batch's blocks and the "
                         "global loss need it)" % n)
    replicated = {name: all(a is None for a in param_spec(name, cfg, mesh))
                  for name in params}
    momenta = {}
    for name, p in params.items():
        m = torch.zeros_like(p)
        if zero.zero1_update_spec(p.shape, replicated[name], n):
            m = zero.sharded_state(m, group)
        momenta[name] = m

    def momentum_sgd(ps, gs, ms, hyper):
        # elementwise, in the JAX formula's order: momentum * m rounded,
        # + g rounded; lr * m rounded, subtracted from p
        torch._foreach_mul_(ms, momentum)
        torch._foreach_add_(ms, [g.to(m.dtype) for g, m in zip(gs, ms)])
        torch._foreach_sub_(ps, torch._foreach_mul(
            [m.to(p.dtype) for p, m in zip(ps, ms)], lr))
        return ps, ms

    if mesh is not None:
        run = _sharded_loss_and_grads(cfg, mesh, seq_axis, (seq_axis,))
        names = list(params)
        reps = [replicated[name] for name in names]

        def sharded_step(params, momenta, tokens, labels):
            loss, grads = run(params, tokens, labels)
            ps = [params[name] for name in names]
            with torch.no_grad():
                new_ps, _ = zero.sharded_update(
                    momentum_sgd, ps, grads, [momenta[nm] for nm in names],
                    {}, group, replicated=reps)
                for p, q in zip(ps, new_ps):
                    if q is not p:
                        p.copy_(q)
            return params, momenta, loss
        return (mesh_mod.jit_sharded(sharded_step,
                                     "transformer_train_step_zero1"),
                momenta)

    dev = next(iter(params.values())).device
    loss_of = _lm_loss_fn(cfg)
    programs = capture.StepCache("make_train_step_zero1")

    def step(params, momenta, tokens, labels):
        tokens, labels = _on_device(dev, params, tokens, labels)
        ps, ms = list(params.values()), [momenta[n] for n in params]

        def body(tokens, labels):
            loss, grads = _loss_and_grads(loss_of, params, tokens, labels)
            with torch.no_grad():
                zero.sharded_update(momentum_sgd, ps, grads, ms, {}, group)
            return [loss]
        (loss,) = _run_step(programs, body, ps + ms, tokens, labels)
        return params, momenta, loss

    return step, momenta


def place_batch(tokens, labels, device=None, mesh=None, seq_axis="seq"):
    """A [B, S] token batch and its labels (numpy arrays or tensors) as
    int64 tensors on ``device`` (default: the first CUDA card); with
    ``mesh``, this rank's block of them over (``data``, ``seq_axis``)."""
    if mesh is not None:
        spec = mesh_mod.filter_spec(("data", seq_axis), mesh)
        return tuple(mesh_mod.shard_put(torch.as_tensor(x), mesh, spec).long()
                     for x in (tokens, labels))
    dev = as_device(device)
    return tuple(torch.as_tensor(x).to(device=dev, dtype=torch.long)
                 for x in (tokens, labels))


class TransformerLM(nn.Module):
    """The LM as a module: ``params`` (from :func:`init_transformer_params`
    or :func:`params_from_jax`) held under their JAX names; ``forward``
    calls :func:`transformer_forward`."""

    def __init__(self, cfg, params):
        super().__init__()
        missing = set(_param_shapes(cfg)) - set(params)
        if missing:
            raise MXNetError("TransformerLM: missing params %s"
                             % sorted(missing))
        self.cfg = cfg
        self.params = nn.ParameterDict(
            {n: nn.Parameter(t, requires_grad=False)
             for n, t in params.items()})

    def forward(self, tokens):
        return transformer_forward(dict(self.params), tokens, self.cfg)
