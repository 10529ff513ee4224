"""Ring attention: exact attention over sequence-sharded inputs.

Counterpart of ``mxnet_tpu/parallel/ring_attention.py``: each rank of the
``seq`` axis holds a block of q, k and v; the K/V blocks travel around
the axis's ring (``collective.ring_exchange``, one ``batch_isend_irecv`` a
step, where the JAX package has ``lax.ppermute``) while an online softmax
in fp32 combines the partial results, with -1e30 masks on absolute int
positions, and the output is divided by ``max(l, 1e-30)`` and cast to q's
dtype (``ring_attention.py:74-118``).  The block step is plain torch
products, as the JAX ring's ``einsum``s are: no hand kernel is on this
path.

The P2P exchanges are not differentiable in torch, so the ring is one
``torch.autograd.Function``: its backward walks the ring again from the
saved log-sum-exp of each row, and the dK/dV of each block travel with it
and come home after the last step.  Every rank of the axis runs the same
steps; call inside ``mesh.shard_map`` (or with the mesh bound).
"""
from __future__ import annotations

import math

import torch

from . import collective
from . import mesh as mesh_mod

__all__ = ["ring_attention", "local_attention", "ring_attention_sharded"]

_NEG = -1e30  # large-negative mask; avoids -inf NaN edge cases in exp


def local_attention(q, k, v, causal=False, sm_scale=None,
                    q_offset=0, k_offset=0):
    """Exact softmax attention on local blocks, in q's dtype.

    q: [B, H, Sq, D]; k, v: [B, H, Sk, D].  ``q_offset``/``k_offset`` are
    the absolute positions of each block's first row (for the causal
    mask when blocks are shards of a longer sequence)."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        s = torch.where(_mask(q.shape[2], k.shape[2], q_offset, k_offset,
                              q.device), s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _mask(sq, sk, q_offset, k_offset, device):
    q_pos = q_offset + torch.arange(sq, dtype=torch.int32, device=device)
    k_pos = k_offset + torch.arange(sk, dtype=torch.int32, device=device)
    return q_pos[:, None] >= k_pos[None, :]


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, idx, n, causal, scale):
        b, h, s_loc, d = q.shape
        qf = q.float()
        acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, h, s_loc), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
        kb, vb = k, v
        for t in range(n):
            src = (idx - t) % n
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kb.float()) * scale
            if causal:
                mask = _mask(s_loc, s_loc, idx * s_loc, src * s_loc,
                             q.device)
                s = torch.where(mask, s, _NEG)
            new_m = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - new_m)
            p = torch.exp(s - new_m[..., None])
            if causal:
                p = torch.where(mask, p, 0.0)     # kill fully-masked rows
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vb.float())
            m = new_m
            if t < n - 1:
                kb, vb = collective.ring_exchange([kb, vb], group)
        l = torch.clamp(l, min=1e-30)
        out = (acc / l[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.ring = (group, idx, n, causal, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, idx, n, causal, scale = ctx.ring
        s_loc = q.shape[2]
        qf, dof = q.float(), do.float()
        delta = (dof * out.float()).sum(dim=-1)
        dq = torch.zeros_like(qf)
        kb, vb = k, v
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros_like(dkb)
        for t in range(n):
            src = (idx - t) % n
            kf, vf = kb.float(), vb.float()
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
            p = torch.exp(s - lse[..., None])
            if causal:
                p = torch.where(_mask(s_loc, s_loc, idx * s_loc, src * s_loc,
                                      q.device), p, 0.0)
            dvb = dvb + torch.einsum("bhqk,bhqd->bhkd", p, dof)
            ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf)
                      - delta[..., None])
            dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
            dkb = dkb + torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
            # the dK/dV of a block travel with it; after n steps they are
            # back on the rank that holds the block
            if t < n - 1:
                kb, vb, dkb, dvb = collective.ring_exchange(
                    [kb, vb, dkb, dvb], group)
            else:
                dkb, dvb = collective.ring_exchange([dkb, dvb], group)
        return (dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype),
                None, None, None, None, None)


def ring_attention(q, k, v, axis_name, causal=False, sm_scale=None):
    """Ring attention over the sequence axis ``axis_name`` of the bound
    mesh.

    q, k, v: this rank's blocks [B, H, S_local, D] (the global sequence is
    S_local times the axis size, block i on the rank of index i).  Returns
    this rank's output block, equal to ``local_attention`` on the
    gathered sequence to fp32 accuracy."""
    group = collective.axis_group(axis_name)
    idx = collective.axis_index(axis_name)
    n = collective.axis_size(axis_name)
    scale = sm_scale if sm_scale is not None else \
        1.0 / math.sqrt(q.shape[-1])
    return _Ring.apply(q, k, v, group, idx, n, causal, scale)


def ring_attention_sharded(q, k, v, mesh, axis_name="seq", causal=False,
                           sm_scale=None):
    """:func:`ring_attention` as a program of ``mesh``: q, k, v and the
    result are this rank's blocks, the sequence dim sharded over
    ``axis_name`` and every other dim whole."""
    spec = mesh_mod.filter_spec((None, None, axis_name, None), mesh)
    fn = mesh_mod.shard_map(
        lambda a, b, c: ring_attention(a, b, c, axis_name, causal, sm_scale),
        mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)
