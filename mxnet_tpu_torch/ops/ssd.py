"""SSD detection ops: ``MultiBoxPrior``, ``MultiBoxTarget`` and
``MultiBoxDetection``.

Counterpart of ``mxnet_tpu/ops/ssd.py``: ``_contrib_MultiBoxPrior``:36,
``_contrib_MultiBoxTarget``:209 and ``_contrib_MultiBoxDetection``:281,
with the helpers ``_iou_matrix``:82, ``_encode_offsets``:98,
``_decode_offsets``:116, ``_match_anchors``:134, ``_target_one``:167 and
``_detect_one``:262.  The JAX package maps one image at a time with
``vmap``; here every step is written over the batch.  Shapes are fixed
and no Python branch reads a tensor's value, so the ops can sit in a
captured program.

- Matching: every valid ground-truth box claims, greedily by IoU, the
  best unclaimed anchor (the first flat argmax, as ``jnp.argmax``),
  G times over the batch; then anchors at or above ``overlap_threshold``
  join their best box.  ``minimum_negative_samples`` is accepted and not
  used, as in the JAX package.
- Every sort is stable (``jnp.argsort`` is): negative mining's order by
  background score and detection's order by score, where zero-score rows
  tie and their order is part of the output.
- Detection's greedy NMS is ``nms.nms``: the hand-written kernel on the
  card, its plain loop on the CPU.

Boxes are corners (xmin, ymin, xmax, ymax) normalised to [0, 1]; a class
of -1 marks a padding label row or a suppressed detection.
"""
from __future__ import annotations

import math

import torch

from .nms import iou_row, nms
from .registry import register

__all__ = ["iou_matrix", "encode_offsets", "decode_offsets",
           "detection_candidates", "nms_trip"]


def _as_floats(v):
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


@register("_contrib_MultiBoxPrior", nondiff_inputs=(0,))
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5), **kw):
    """Anchors of every cell of data (N, C, H, W): (1, H*W*A, 4) with
    A = len(sizes) + len(ratios) - 1, each size with ratios[0], then
    sizes[0] with each other ratio; ``steps`` and ``offsets`` are (y, x)."""
    sizes, ratios = _as_floats(sizes), _as_floats(ratios)
    h, w = data.shape[2], data.shape[3]
    dev, f32 = data.device, torch.float32
    step_y = float(steps[0]) if steps[0] > 0 else 1.0 / h
    step_x = float(steps[1]) if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=f32, device=dev) + float(offsets[0])) * step_y
    cx = (torch.arange(w, dtype=f32, device=dev) + float(offsets[1])) * step_x
    cy, cx = torch.meshgrid(cy, cx, indexing="ij")
    # each half extent in float32, rounded as the JAX package rounds it,
    # made on the device (no host copy: the op can sit in a captured graph)
    half_w, half_h = [], []
    r0 = torch.sqrt(torch.full((), ratios[0], dtype=f32, device=dev))
    for s in sizes:
        half_w.append(s * r0 / 2.0)
        half_h.append(s / r0 / 2.0)
    for r in ratios[1:]:
        rs = torch.sqrt(torch.full((), r, dtype=f32, device=dev))
        half_w.append(sizes[0] * rs / 2.0)
        half_h.append(sizes[0] / rs / 2.0)
    half_w, half_h = torch.stack(half_w), torch.stack(half_h)
    boxes = torch.stack([cx[..., None] - half_w, cy[..., None] - half_h,
                         cx[..., None] + half_w, cy[..., None] + half_h],
                        dim=-1).reshape(1, h * w * half_w.shape[0], 4)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    return boxes.to(data.dtype)


def iou_matrix(anchors, gt_boxes):
    """IoU of anchors (A, 4) with boxes (..., G, 4) -> (..., A, G)."""
    return iou_row(anchors[:, None, :], gt_boxes[..., None, :, :])


def _corners(b):
    return b[..., 0], b[..., 1], b[..., 2], b[..., 3]


def encode_offsets(anchors, matched, variances):
    """Corner boxes -> (dx, dy, dw, dh) regression targets against the
    anchors (broadcast over leading dims)."""
    a0, a1, a2, a3 = _corners(anchors)
    g0, g1, g2, g3 = _corners(matched)
    aw, ah = a2 - a0, a3 - a1
    acx, acy = (a0 + a2) / 2, (a1 + a3) / 2
    gw, gh = g2 - g0, g3 - g1
    gcx, gcy = (g0 + g2) / 2, (g1 + g3) / 2
    eps = 1e-8
    dx = (gcx - acx) / aw.clamp(min=eps) / variances[0]
    dy = (gcy - acy) / ah.clamp(min=eps) / variances[1]
    dw = torch.log(gw.clamp(min=eps) / aw.clamp(min=eps)) / variances[2]
    dh = torch.log(gh.clamp(min=eps) / ah.clamp(min=eps)) / variances[3]
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_offsets(anchors, deltas, variances):
    """Inverse of :func:`encode_offsets` -> corner boxes."""
    a0, a1, a2, a3 = _corners(anchors)
    aw, ah = a2 - a0, a3 - a1
    acx, acy = (a0 + a2) / 2, (a1 + a3) / 2
    cx = deltas[..., 0] * variances[0] * aw + acx
    cy = deltas[..., 1] * variances[1] * ah + acy
    w = torch.exp(deltas[..., 2] * variances[2]) * aw
    h = torch.exp(deltas[..., 3] * variances[3]) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _match_anchors(ious, valid, overlap_threshold):
    """(B, A) index of each anchor's box, or -1: threshold matches first,
    then every valid box claims the best unclaimed anchor, G times."""
    b, n_anchor, n_gt = ious.shape
    ious = torch.where(valid[:, None, :], ious, torch.full_like(ious, -1.0))
    best_gt = ious.argmax(dim=2)  # the first of equal maxima
    best_iou = ious.gather(2, best_gt[..., None])[..., 0]
    match = torch.where(best_iou >= overlap_threshold, best_gt,
                        torch.full_like(best_gt, -1))
    pool = ious.clone()
    rows = torch.arange(n_anchor, device=ious.device)
    cols = torch.arange(n_gt, device=ious.device)
    for _ in range(n_gt):
        flat = pool.reshape(b, -1).argmax(dim=1)
        a_idx, g_idx = flat // n_gt, flat % n_gt
        good = pool.reshape(b, -1).gather(1, flat[:, None])[:, 0] > 0
        hit = (rows[None, :] == a_idx[:, None]) & good[:, None]   # (B, A)
        match = torch.where(hit, g_idx[:, None], match)
        gone = (cols[None, :] == g_idx[:, None]) & good[:, None]  # (B, G)
        pool = pool.masked_fill(hit[:, :, None] | gone[:, None, :], -1.0)
    return match


@register("_contrib_MultiBoxTarget", num_outputs=3, nondiff_inputs=(0, 1, 2))
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5, minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2), **kw):
    """Anchor-to-box matching.  anchor (1, A, 4); label (N, G, 5) rows
    [cls, x0, y0, x1, y1], cls < 0 padding; cls_pred (N, C+1, A).
    Outputs loc_target (N, 4A), loc_mask (N, 4A), cls_target (N, A)."""
    variances = _as_floats(variances)
    anchors = anchor.reshape(-1, 4)
    batch, n_gt = label.shape[0], label.shape[1]
    gt_cls, gt_boxes = label[..., 0], label[..., 1:5]
    valid = gt_cls >= 0
    ious = iou_matrix(anchors, gt_boxes)                       # (B, A, G)
    best_iou_any = torch.where(valid[:, None, :], ious,
                               torch.zeros_like(ious)).amax(dim=2)
    match = _match_anchors(ious, valid, float(overlap_threshold))
    is_fg = match >= 0
    safe = match.clamp(0, n_gt - 1)
    zero = torch.zeros((), dtype=label.dtype, device=label.device)
    cls_target = torch.where(is_fg, gt_cls.gather(1, safe) + 1.0, zero)
    matched = gt_boxes.gather(1, safe[..., None].expand(-1, -1, 4))
    loc = encode_offsets(anchors, matched, variances)
    loc_target = torch.where(is_fg[..., None], loc,
                             torch.zeros_like(loc)).reshape(batch, -1)
    loc_mask = torch.where(is_fg[..., None], torch.ones_like(loc),
                           torch.zeros_like(loc)).reshape(batch, -1)
    if float(negative_mining_ratio) > 0:
        # hard negatives: the lowest background scores among anchors that
        # are neither matched nor near a box
        neg_mask = ~is_fg & (best_iou_any < float(negative_mining_thresh))
        bg = cls_pred[:, 0, :]
        hardness = torch.where(neg_mask, -bg, torch.full_like(bg, -math.inf))
        n_fg = is_fg.sum(dim=1)
        quota = (float(negative_mining_ratio) * n_fg.double()).to(
            torch.int32).clamp(min=1)
        order = torch.sort(-hardness, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(order.shape[1], device=order.device)
            .expand_as(order).contiguous())
        keep_neg = neg_mask & (rank < quota[:, None])
        cls_target = torch.where(
            is_fg, cls_target,
            torch.where(keep_neg, zero, zero + float(ignore_label)))
    dt = anchor.dtype
    return loc_target.to(dt), loc_mask.to(dt), cls_target.to(dt)


def detection_candidates(cls_prob, loc_pred, anchor, clip=True,
                         threshold=0.01, background_id=0,
                         variances=(0.1, 0.1, 0.2, 0.2)):
    """MultiBoxDetection before its NMS: the decoded rows (N, A, 6)
    [class, score, x0, y0, x1, y1] in stable score order, class -1 where
    the best score is not above ``threshold`` (NMS's input)."""
    variances = _as_floats(variances)
    anchors = anchor.reshape(-1, 4)
    batch, n = cls_prob.shape[0], anchors.shape[0]
    boxes = decode_offsets(anchors, loc_pred.reshape(batch, n, 4), variances)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    masked = cls_prob.clone()
    masked[:, int(background_id)] = -math.inf
    best_score, _ = masked.max(dim=1)
    best_cls = masked.argmax(dim=1)           # the first of equal maxima
    keep = best_score > float(threshold)
    cls_id = torch.where(keep, best_cls.to(torch.float32) - 1.0,
                         torch.full_like(best_score, -1.0, dtype=torch.float32))
    score = torch.where(keep, best_score, torch.zeros_like(best_score))
    dt = torch.promote_types(torch.promote_types(score.dtype, boxes.dtype),
                             torch.float32)
    dets = torch.cat([cls_id[..., None].to(dt), score[..., None].to(dt),
                      boxes.to(dt)], dim=-1)                    # (B, A, 6)
    order = torch.sort(-dets[..., 1], dim=1, stable=True).indices
    return dets.gather(1, order[..., None].expand(-1, -1, 6))


def nms_trip(nms_topk, n):
    """The NMS walk's length: the first ``nms_topk`` boxes, or all."""
    topk = int(nms_topk)
    return min(topk, n) if topk > 0 else n


@register("_contrib_MultiBoxDetection", nondiff_inputs=(0, 1, 2))
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, background_id=0, nms_threshold=0.5,
                        force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1, **kw):
    """Decode and greedy NMS.  cls_prob (N, C+1, A); loc_pred (N, 4A);
    anchor (1, A, 4).  Output (N, A, 6) rows [class, score, x0, y0, x1, y1]
    sorted by score, class -1 where void or suppressed."""
    dets = detection_candidates(cls_prob, loc_pred, anchor, clip, threshold,
                                background_id, variances)
    alive = nms(dets[..., 2:6], dets[..., 0], dets[..., 0] >= 0,
                nms_trip(nms_topk, dets.shape[1]), float(nms_threshold),
                bool(force_suppress))
    out = torch.cat([torch.where(alive, dets[..., 0],
                                 torch.full_like(dets[..., 0], -1.0))[..., None],
                     dets[..., 1:]], dim=-1)
    return out.to(cls_prob.dtype)
