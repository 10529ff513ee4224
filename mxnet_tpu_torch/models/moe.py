"""Mixture-of-experts FFN with expert parallelism.

Counterpart of ``mxnet_tpu/models/moe.py:30-115``: switch-style top-1
routing with a capacity (tokens past an expert's capacity drop and ride
the caller's residual), in the dispatch/combine formulation, so routing,
capacity and dropped tokens are the JAX package's.  With a mesh the
experts shard over ``expert_axis`` (default ``model``): each rank holds
its block of experts, routes every token (the tokens are whole on every
rank of the axis), runs its own experts, and the outputs are summed over
the axis (Megatron's "g": a token's output comes from one expert, the
other ranks add zeros, so the sum is exact).  Megatron's "f" on the
tokens and on the router's logits makes the gradients of the tokens and
of the replicated router whole on every rank.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..context import as_device
from ..parallel import collective
from ..parallel import mesh as mesh_mod

__all__ = ["init_moe_params", "moe_ffn", "moe_param_specs"]


def moe_param_specs(d_model, d_ff, n_experts, expert_axis="model"):
    """name -> (shape, spec) with the expert dim sharded."""
    e = expert_axis
    return {
        "gate_w": ((d_model, n_experts), ()),
        "expert_w1": ((n_experts, d_model, d_ff), (e, None, None)),
        "expert_b1": ((n_experts, d_ff), (e, None)),
        "expert_w2": ((n_experts, d_ff, d_model), (e, None, None)),
    }


def init_moe_params(generator, d_model, d_ff, n_experts, mesh=None,
                    dtype=torch.float32, expert_axis="model", device=None):
    """Random params (zeros for ``expert_b1``, N(0, 1/fan_in) elsewhere)
    from ``generator``, on ``device`` (default: the first CUDA card) or
    ``mesh``'s device, where each rank keeps its shard of the one global
    draw."""
    dev = mesh.device if mesh is not None else as_device(device)
    params = {}
    for name, (shape, spec) in sorted(moe_param_specs(
            d_model, d_ff, n_experts, expert_axis).items()):
        if name == "expert_b1":
            v = torch.zeros(shape, dtype=dtype, device=dev)
        else:
            fan_in = shape[-2] if name != "gate_w" else shape[0]
            v = (torch.randn(shape, generator=generator, dtype=torch.float32,
                             device=dev)
                 * (1.0 / math.sqrt(max(fan_in, 1)))).to(dtype)
        if mesh is not None:
            v = mesh_mod.shard_put(v, mesh, mesh_mod.filter_spec(spec, mesh))
        params[name] = v
    return params


def _route_top1(logits, capacity):
    """Switch routing: each token's argmax expert, with a capacity cut.

    Returns (dispatch [n, E, C] in {0, 1}, combine [n, E, C]): dispatch
    puts token n in its expert's slot, combine takes the expert's output
    back scaled by the gate probability; a token past its expert's
    capacity has all-zero rows (dropped)."""
    n, num_experts = logits.shape
    gates = torch.softmax(logits.float(), dim=-1)
    expert_idx = torch.argmax(gates, dim=-1)                  # [n]
    onehot = F.one_hot(expert_idx, num_experts).float()       # [n, E]
    # position of each token within its chosen expert's queue, 1-based
    pos = torch.cumsum(onehot, dim=0) * onehot
    within = (pos > 0) & (pos <= capacity)
    slot = torch.clamp(pos - 1, 0, capacity - 1).long()
    slot_oh = F.one_hot(slot.amax(dim=-1), capacity).float()  # [n, C]
    dispatch = (onehot * within)[:, :, None] * slot_oh[:, None, :]
    gate_val = torch.sum(gates * onehot, dim=-1)              # [n]
    combine = dispatch * gate_val[:, None, None]
    return dispatch, combine


def moe_ffn(x, params, capacity_factor=1.25, mesh=None,
            expert_axis="model"):
    """The routed expert FFN on ``x`` [B, S, D] -> [B, S, D]; add the
    result to a residual (dropped tokens contribute zero here).

    With ``mesh``, ``x`` is whole on every rank of ``expert_axis`` and the
    expert params are this rank's shards (``init_moe_params(mesh=...)``);
    the result is whole on every rank of the axis."""
    b, s, d = x.shape
    n = b * s
    axis = None
    if mesh is not None and mesh.shape.get(expert_axis, 1) > 1:
        axis = expert_axis
    shards = mesh.shape[expert_axis] if axis else 1
    num_experts = params["expert_w1"].shape[0] * shards
    capacity = max(1, int(math.ceil(capacity_factor * n / num_experts)))
    with (mesh_mod.using_mesh(mesh) if axis else contextlib.nullcontext()):
        flat = x.reshape(n, d)
        logits = flat @ params["gate_w"]
        if axis:
            logits = collective.copy_to_axis(logits, axis)
            flat = collective.copy_to_axis(flat, axis)
        dispatch, combine = _route_top1(logits, capacity)
        if axis:
            e = params["expert_w1"].shape[0]
            lo = collective.axis_index(axis) * e
            dispatch, combine = dispatch[:, lo:lo + e], combine[:, lo:lo + e]
        expert_in = torch.einsum("nec,nd->ecd", dispatch.to(flat.dtype),
                                 flat)
        h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in,
                                params["expert_w1"])
                   + params["expert_b1"][:, None, :], approximate="tanh")
        out_e = torch.einsum("ecf,efd->ecd", h, params["expert_w2"])
        out = torch.einsum("nec,ecd->nd", combine.to(out_e.dtype), out_e)
        if axis:
            out = collective.reduce_from_axis(out, axis)
    return out.reshape(b, s, d)
