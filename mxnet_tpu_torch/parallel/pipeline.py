"""Pipeline parallelism: GPipe microbatch streaming over a mesh axis.

Counterpart of ``mxnet_tpu/parallel/pipeline.py:34-129``: S stages, one
a rank of the ``pipe`` axis (each rank holds its stage's parameters, the
stacked parameters' leading dim sharded over the axis), and M
microbatches streamed through them in the GPipe fill-drain schedule of
M + S - 1 ticks.  At tick t the rank of stage s runs microbatch t - s
(when there is one), then sends its activation to stage s + 1 by P2P
along the axis's group; the last stage's outputs go to every rank of the
axis.  Where the JAX package runs every stage at every tick on whatever
sits in its slot, this one runs a stage only on a real microbatch: the
outputs are the same.

``torch.distributed``'s P2P ops are not differentiable, so the schedule
is one ``torch.autograd.Function``: its backward runs the schedule the
other way round, each stage recomputing its forward from its saved input
and sending the input's gradient to the stage before, so ``backward``
through ``pipeline_apply`` trains every stage.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..base import MXNetError
from . import collective
from . import mesh as mesh_mod

__all__ = ["pipeline_apply"]


def _exchange(group, ranks, sends, recvs):
    """One tick's P2P: ``sends``/``recvs`` are ``(stage, tensor)``."""
    collective.exchange([(ranks[r], t) for r, t in sends],
                        [(ranks[r], t) for r, t in recvs], group)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, micro, stage_fn, names, sched, *leaves):
        group, ranks, stage, n_stages, n_micro = sched
        params = dict(zip(names, leaves))
        inputs, outs = [None] * n_micro, torch.zeros_like(micro)
        recv = None
        for t in range(n_micro + n_stages - 1):
            m = t - stage
            sends, recvs = [], []
            if 0 <= m < n_micro:
                x = micro[m] if stage == 0 else recv
                inputs[m] = x
                y = stage_fn(params, x)
                if stage == n_stages - 1:
                    outs[m] = y
                else:
                    sends.append((stage + 1, y.contiguous()))
            # the stage before runs microbatch t - stage + 1 at this tick
            if stage > 0 and 0 <= m + 1 < n_micro:
                recv = torch.empty_like(micro[0])
                recvs.append((stage - 1, recv))
            _exchange(group, ranks, sends, recvs)
        # the last stage's outputs, on every rank of the axis
        outs = collective._all_reduce(
            outs if stage == n_stages - 1 else torch.zeros_like(outs), group)
        ctx.stage_fn, ctx.names, ctx.sched = stage_fn, names, sched
        ctx.inputs = inputs
        ctx.save_for_backward(*leaves)
        return outs

    @staticmethod
    def backward(ctx, douts):
        group, ranks, stage, n_stages, n_micro = ctx.sched
        leaves = ctx.saved_tensors
        grads = [torch.zeros_like(p) for p in leaves]
        dmicro = torch.zeros_like(douts)
        dy = None
        # backward tick u: stage s runs microbatch M - 1 - (u - (S-1-s))
        for u in range(n_micro + n_stages - 1):
            m = n_micro - 1 - (u - (n_stages - 1 - stage))
            sends, recvs = [], []
            if 0 <= m < n_micro:
                g = douts[m] if stage == n_stages - 1 else dy
                x = ctx.inputs[m].detach().requires_grad_()
                ps = [p.detach().requires_grad_() for p in leaves]
                with torch.enable_grad():
                    y = ctx.stage_fn(dict(zip(ctx.names, ps)), x)
                    dx, *dps = torch.autograd.grad(y, [x] + ps, g,
                                                   allow_unused=True)
                for acc, d in zip(grads, dps):
                    if d is not None:
                        acc.add_(d)
                if stage == 0:
                    dmicro[m] = dx
                else:
                    sends.append((stage - 1, dx.contiguous()))
            # the stage after runs microbatch m - 1 of this stage's order
            # at this tick, and sends its input's gradient here
            if stage < n_stages - 1 and 0 <= m - 1 < n_micro:
                dy = torch.empty_like(douts[0])
                recvs.append((stage + 1, dy))
            _exchange(group, ranks, sends, recvs)
        # the input is whole on every rank: its gradient is stage 0's
        dmicro = collective._all_reduce(dmicro, group)
        return (dmicro, None, None, None) + tuple(grads)


def pipeline_apply(stage_fn, stage_params, x, mesh, n_microbatches,
                   axis="pipe"):
    """Apply S pipeline stages to ``x`` with microbatch streaming.

    ``stage_fn(params, activation) -> activation`` is one stage's work
    (activations keep one shape across stages); ``stage_params`` is this
    rank's block of the stacked stage parameters, ``{name: tensor}`` with
    a leading stage dim of 1 (``mesh.shard_put(stacked, mesh, (axis,))``);
    ``x`` [B, ...] is whole on every rank of ``axis``, B divisible by
    ``n_microbatches``.  Returns the full batch's output, on every rank of
    the axis, equal to the stages applied in sequence.  Every rank of the
    axis calls it."""
    b = x.shape[0]
    if b % n_microbatches:
        raise MXNetError("pipeline_apply: batch %d does not divide into %d "
                         "microbatches" % (b, n_microbatches))
    n_stages = mesh.shape[axis]
    names = sorted(stage_params)
    for n in names:
        if stage_params[n].shape[0] != 1:
            raise MXNetError("pipeline_apply: %s has a leading dim of %d, "
                             "want this rank's one stage"
                             % (n, stage_params[n].shape[0]))
    with mesh_mod.using_mesh(mesh):
        group = collective.axis_group(axis)
        sched = (group, dist.get_process_group_ranks(group),
                 collective.axis_index(axis), n_stages, n_microbatches)

    def fn(params, h):
        return stage_fn({n: p[0] for n, p in params.items()}, h)
    micro = x.reshape((n_microbatches, b // n_microbatches) + x.shape[1:])
    outs = _Pipeline.apply(micro, fn, names, sched,
                           *[stage_params[n] for n in names])
    return outs.reshape((b,) + outs.shape[2:])
