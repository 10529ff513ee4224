"""Random draws: the ``_random_*`` shape samplers, the ``_sample_*``
samplers whose parameters are tensors, ``_sample_multinomial`` and
``shuffle``.

Counterpart of ``mxnet_tpu/ops/random_ops.py:19-146``, with its names,
aliases and attrs.  Every op is ``needs_rng``: it draws from the
``torch.Generator`` the caller passes (``random.generator(ctx)`` of the
op's device), never from torch's global generator, and makes its output
on that generator's device (or the one its ``ctx`` attr names).  The
streams are torch's, not JAX's threefry, so the two packages agree in
distribution, not draw for draw.  The negative binomials are the
gamma-Poisson mixture the JAX package uses; the Gamma draws are
``torch._standard_gamma``'s, scaled by ``beta``.  On ``meta`` tensors
(shape inference) an op returns an empty tensor of the draw's shape.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import op_device, register


def _shape(shape):
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape or ())


def _draw(shape, dtype, ctx, rng, fn):
    """``fn(shape, device)`` in fp32 (or fp64), cast to ``dtype``; an empty
    tensor on the meta device."""
    dt = torch_dtype(dtype)
    dev = op_device(ctx, rng)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dt, device=dev)
    work = torch.float64 if dt == torch.float64 else torch.float32
    return fn(shape, dev, work).to(dt)


def _uniform(rng, shape, dev, dt, low, high):
    return torch.rand(shape, generator=rng, device=dev, dtype=dt) \
        * (high - low) + low


def _gamma(rng, alpha, scale=1.0):
    """Gamma(alpha) draws of ``alpha``'s shape, times ``scale``."""
    return torch._standard_gamma(alpha, generator=rng) * scale


def _poisson(rng, lam):
    return torch.poisson(lam, generator=rng)


@register("_random_uniform", aliases=["uniform", "random_uniform"],
          needs_rng=True, no_inputs=True)
def _random_uniform(low=0.0, high=1.0, shape=(), dtype="float32", ctx=None,
                    rng=None, **kw):
    return _draw(_shape(shape), dtype, ctx, rng, lambda s, d, w: _uniform(
        rng, s, d, w, low, high))


@register("_random_normal", aliases=["normal", "random_normal"],
          needs_rng=True, no_inputs=True)
def _random_normal(loc=0.0, scale=1.0, shape=(), dtype="float32", ctx=None,
                   rng=None, **kw):
    return _draw(_shape(shape), dtype, ctx, rng, lambda s, d, w: loc + scale
                 * torch.randn(s, generator=rng, device=d, dtype=w))


@register("_random_gamma", aliases=["random_gamma"], needs_rng=True,
          no_inputs=True)
def _random_gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32", ctx=None,
                  rng=None, **kw):
    return _draw(_shape(shape), dtype, ctx, rng, lambda s, d, w: _gamma(
        rng, torch.full(s, float(alpha), device=d, dtype=w), beta))


@register("_random_exponential", aliases=["random_exponential"],
          needs_rng=True, no_inputs=True)
def _random_exponential(lam=1.0, shape=(), dtype="float32", ctx=None,
                        rng=None, **kw):
    return _draw(_shape(shape), dtype, ctx, rng, lambda s, d, w: torch.empty(
        s, device=d, dtype=w).exponential_(1.0, generator=rng) / lam)


@register("_random_poisson", aliases=["random_poisson"], needs_rng=True,
          no_inputs=True)
def _random_poisson(lam=1.0, shape=(), dtype="float32", ctx=None, rng=None,
                    **kw):
    return _draw(_shape(shape), dtype, ctx, rng, lambda s, d, w: _poisson(
        rng, torch.full(s, float(lam), device=d, dtype=w)))


def _gamma_poisson(rng, s, d, w, k, p):
    """The negative binomial NB(k, p) as Poisson(Gamma(k) (1 - p) / p)."""
    lam = _gamma(rng, torch.full(s, float(k), device=d, dtype=w),
                 (1 - p) / p)
    return _poisson(rng, lam)


@register("_random_negative_binomial", aliases=["random_negative_binomial"],
          needs_rng=True, no_inputs=True)
def _random_negbin(k=1, p=1.0, shape=(), dtype="float32", ctx=None,
                   rng=None, **kw):
    return _draw(_shape(shape), dtype, ctx, rng, lambda s, d, w:
                 _gamma_poisson(rng, s, d, w, k, p))


@register("_random_generalized_negative_binomial",
          aliases=["random_generalized_negative_binomial"], needs_rng=True,
          no_inputs=True)
def _random_gnegbin(mu=1.0, alpha=1.0, shape=(), dtype="float32", ctx=None,
                    rng=None, **kw):
    def fn(s, d, w):
        if alpha == 0:
            return _poisson(rng, torch.full(s, float(mu), device=d, dtype=w))
        r = 1.0 / alpha
        return _gamma_poisson(rng, s, d, w, r, r / (r + mu))
    return _draw(_shape(shape), dtype, ctx, rng, fn)


@register("_random_randint", aliases=["random_randint"], needs_rng=True,
          no_inputs=True)
def _random_randint(low=0, high=1, shape=(), dtype="int32", ctx=None,
                    rng=None, **kw):
    dt = torch_dtype(dtype)
    dev = op_device(ctx, rng)
    if dev.type == "meta":
        return torch.empty(_shape(shape), dtype=dt, device=dev)
    return torch.randint(int(low), int(high), _shape(shape), generator=rng,
                         device=dev).to(dt)


@register("_sample_multinomial", aliases=["sample_multinomial"],
          needs_rng=True, nondiff_inputs=(0,),
          num_outputs=lambda a: 2 if a.get("get_prob", False) else 1)
def _sample_multinomial(data, shape=(), get_prob=False, dtype="int32",
                        rng=None, **kw):
    s = _shape(shape)
    n = 1
    for v in s:
        n *= v
    dt = torch_dtype(dtype)
    out_shape = data.shape[:-1] + s
    if data.device.type == "meta":
        samp = torch.empty(out_shape, dtype=dt, device="meta")
    else:
        probs = data.reshape(-1, data.shape[-1]).float()
        samp = torch.multinomial(probs, n, replacement=True,
                                 generator=rng).reshape(out_shape).to(dt)
    if not get_prob:
        return samp
    logp = torch.log_softmax(torch.log(torch.clamp_min(data, 1e-37)), dim=-1)
    lp = torch.gather(logp, -1, samp.reshape(data.shape[:-1] + (-1,)).long())
    return samp, lp.reshape(samp.shape)


def _mk_tensor_sampler(sampler):
    """A sampler of tensor parameters: each parameter's element i gives the
    distribution of ``out[i, ...]``, of shape ``params[0].shape + shape``."""
    def fn(*params, shape=(), dtype="float32", rng=None, **kw):
        s = _shape(shape)
        first = params[0]
        out_shape = tuple(first.shape) + s
        if first.device.type == "meta":
            return torch.empty(out_shape, dtype=torch_dtype(dtype),
                               device="meta")
        work = torch.float64 if first.dtype == torch.float64 \
            else torch.float32
        wide = [p.to(work).reshape(tuple(p.shape) + (1,) * len(s))
                .expand(out_shape) for p in params]
        return sampler(rng, out_shape, first.device, work, *wide).to(
            torch_dtype(dtype))
    return fn


register("_sample_uniform", aliases=["sample_uniform"], needs_rng=True,
         nondiff_inputs=(0, 1))(_mk_tensor_sampler(
             lambda rng, s, d, w, lo, hi: _uniform(rng, s, d, w, lo, hi)))
register("_sample_normal", aliases=["sample_normal"], needs_rng=True,
         nondiff_inputs=(0, 1))(_mk_tensor_sampler(
             lambda rng, s, d, w, mu, sig: mu + sig * torch.randn(
                 s, generator=rng, device=d, dtype=w)))
register("_sample_gamma", aliases=["sample_gamma"], needs_rng=True,
         nondiff_inputs=(0, 1))(_mk_tensor_sampler(
             lambda rng, s, d, w, a, b: _gamma(rng, a.contiguous()) * b))
register("_sample_exponential", aliases=["sample_exponential"],
         needs_rng=True, nondiff_inputs=(0,))(_mk_tensor_sampler(
             lambda rng, s, d, w, lam: torch.empty(s, device=d, dtype=w)
             .exponential_(1.0, generator=rng) / lam))
register("_sample_poisson", aliases=["sample_poisson"], needs_rng=True,
         nondiff_inputs=(0,))(_mk_tensor_sampler(
             lambda rng, s, d, w, lam: _poisson(rng, lam.contiguous())))


@register("shuffle", aliases=["_shuffle"], needs_rng=True)
def _shuffle(data, rng=None, **kw):
    """A random permutation of ``data``'s rows."""
    if data.device.type == "meta":
        return torch.empty_like(data)
    return data[torch.randperm(data.shape[0], generator=rng,
                               device=data.device)]
