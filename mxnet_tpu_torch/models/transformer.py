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
is one replay of a captured CUDA graph (``capture``).  The mesh
(data/tensor/sequence-parallel) path is not ported yet.
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
from ..parallel import zero

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


def _param_shapes(cfg):
    """name -> shape, as the JAX package's ``_param_specs`` names them."""
    hd = cfg.d_model // cfg.n_heads
    shapes = {
        "embed": (cfg.vocab, cfg.d_model),
        "pos_embed": (cfg.max_len, cfg.d_model),
        "out_norm_scale": (cfg.d_model,),
        "out_proj": (cfg.d_model, cfg.vocab),
    }
    for i in range(cfg.n_layers):
        pre = "layer%d_" % i
        shapes.update({
            pre + "wq": (cfg.d_model, cfg.n_heads, hd),
            pre + "wk": (cfg.d_model, cfg.n_heads, hd),
            pre + "wv": (cfg.d_model, cfg.n_heads, hd),
            pre + "wo": (cfg.n_heads, hd, cfg.d_model),
            pre + "w1": (cfg.d_model, cfg.d_ff),
            pre + "b1": (cfg.d_ff,),
            pre + "w2": (cfg.d_ff, cfg.d_model),
            pre + "norm1_scale": (cfg.d_model,),
            pre + "norm2_scale": (cfg.d_model,),
        })
    return shapes


def init_transformer_params(generator, cfg, device=None):
    """Random params: ones for norm scales, zeros for ``b1``, and
    N(0, 1/fan_in) elsewhere, where fan-in is the contracted dims (the
    leading axis, all but the last for ``wo``).  ``generator`` is a
    ``torch.Generator`` on ``device`` (default: the first CUDA card)."""
    dev = as_device(device)
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
    return params


def params_from_jax(np_params, cfg, device=None):
    """The JAX package's ``{name: array}`` params as this package's
    tensors: same names, shapes and layouts, in ``cfg.dtype``."""
    dev = as_device(device)
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
    return params


def _rmsnorm(x, scale):
    # variance in fp32; normalise, cast back to x's dtype, then scale
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale


def _causal_attn_local(q, k, v):
    # the einsum views (strides (S*H*D, D, H*D, 1)) go to the kernel as
    # they are: it reads them through their strides
    return flash_attention(q, k, v, causal=True)


def transformer_forward(params, tokens, cfg):
    """Causal LM forward: tokens [B, S] int -> logits [B, S, vocab], on the
    device the params live on."""
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


def make_train_step(cfg, lr=0.1, device=None):
    """The train step ``step(params, tokens, labels) -> (new_params,
    loss)``: the gradients of the mean next-token NLL, then
    ``p - lr * g`` for every parameter, as the JAX package's
    ``make_train_step`` on one device.  ``device`` (default: the first
    CUDA card) is where the params must lie; tokens and labels are moved
    there.  The update is in place, so ``new_params`` is ``params``: the
    JAX step donates them, so callers already treat the old dict as
    consumed.  On the card the step is one replay of a captured program
    (``capture``), as the JAX step is one jitted program; the loss comes
    back as a copy."""
    dev = as_device(device)
    loss_of = _lm_loss_fn(cfg)
    programs = capture.StepCache("make_train_step")

    def step(params, tokens, labels):
        tokens, labels = _on_device(dev, params, tokens, labels)
        ps = list(params.values())

        def body(tokens, labels):
            loss, grads = _loss_and_grads(loss_of, params, tokens, labels)
            with torch.no_grad():
                # lr * g rounded to the param's dtype, then subtracted: the
                # JAX package's order of operations
                torch._foreach_sub_(ps, torch._foreach_mul(
                    [g.to(p.dtype) for p, g in zip(ps, grads)], lr))
            return [loss]
        (loss,) = _run_step(programs, body, ps, tokens, labels)
        return params, loss

    return step


def make_train_step_zero1(cfg, params, lr=0.1, momentum=0.9, group=None):
    """SGD with momentum through the ZeRO-1 update (``parallel.zero``), as
    the JAX package's ``make_train_step_zero1``: ``m = momentum * m + g``,
    then ``p = p - lr * m``.  ``group`` is the data-parallel group (None:
    one rank, where no update shards and the step is the replicated
    update).  Returns ``(step, momenta)``, the momenta zeros like each
    param, with ``step(params, momenta, tokens, labels) -> (new_params,
    new_momenta, loss)`` on the device the params lie on, updating both
    dicts in place; on the card one replay of a captured program, as
    :func:`make_train_step`."""
    momenta = {n: torch.zeros_like(p) for n, p in params.items()}
    dev = next(iter(params.values())).device
    loss_of = _lm_loss_fn(cfg)
    programs = capture.StepCache("make_train_step_zero1")

    def momentum_sgd(ps, gs, ms, hyper):
        # elementwise, in the JAX formula's order: momentum * m rounded,
        # + g rounded; lr * m rounded, subtracted from p
        torch._foreach_mul_(ms, momentum)
        torch._foreach_add_(ms, [g.to(m.dtype) for g, m in zip(gs, ms)])
        torch._foreach_sub_(ps, torch._foreach_mul(
            [m.to(p.dtype) for p, m in zip(ps, ms)], lr))
        return ps, ms

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


def place_batch(tokens, labels, device=None):
    """A [B, S] token batch and its labels (numpy arrays or tensors) as
    int64 tensors on ``device`` (default: the first CUDA card)."""
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
