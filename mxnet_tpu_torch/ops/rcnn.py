"""Faster R-CNN ops: ``Proposal``, ``MultiProposal``, ``PSROIPooling``,
``DeformableConvolution`` and ``DeformablePSROIPooling``.

Counterpart of ``mxnet_tpu/ops/rcnn.py``: ``_contrib_Proposal``:148,
``_contrib_MultiProposal``:165, ``_contrib_PSROIPooling``:230,
``_contrib_DeformableConvolution``:323 and
``_contrib_DeformablePSROIPooling``:344, with the helpers
``_base_anchors``:37, ``_bbox_transform_inv``:53, ``_proposal_one``:70,
``_psroi_pool_one``:175, ``_bilinear_sample_chw``:243 and
``_deform_conv_one``:268.  The JAX package maps one image or one roi at a
time with ``vmap``; here each op is written over the batch or the rois.

- Proposal keeps the fixed ``rpn_post_nms_top_n`` rows an image with the
  suppressed ones zeroed: decode, clip, drop boxes under ``rpn_min_size``
  (score -inf), take the ``rpn_pre_nms_top_n`` best (``lax.top_k``'s
  order: the lower index first among equals, from a stable sort), greedy
  class-agnostic NMS over them (``nms.nms``: the hand-written kernel on
  the card), then the survivors first in a stable order.
- Deformable convolution is a bilinear gather of the input at the offset
  sampling points (clamped to the image, the high index clamped apart, so
  an integer point samples exactly), then one GEMM against the weights
  (``torch.einsum``), per group where ``num_group`` > 1.
- PS ROI pooling samples a fixed 2 x 2 bilinear grid in each bin and
  averages it, as the JAX package does (not the reference's integer bins).
"""
from __future__ import annotations

import math

import torch

from .nms import nms
from .registry import register

__all__ = ["base_anchors", "bbox_transform_inv", "bilinear_sample_chw",
           "proposal_candidates"]


def _as_floats(v):
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


def base_anchors(scales, ratios, base_size):
    """(A, 4) pixel-coordinate anchors centred on ((base-1)/2, (base-1)/2),
    each ratio with each scale, in float32."""
    base = float(base_size)
    cx = cy = (base - 1.0) / 2.0
    out = []
    for r in ratios:
        w = float(round(math.sqrt(base * base / r)))
        h = float(round(w * r))
        for s in scales:
            ws, hs = w * s, h * s
            out.append([cx - (ws - 1) / 2, cy - (hs - 1) / 2,
                        cx + (ws - 1) / 2, cy + (hs - 1) / 2])
    return torch.tensor(out, dtype=torch.float64).to(torch.float32)


def bbox_transform_inv(boxes, deltas):
    """(dx, dy, dw, dh) deltas applied to pixel corner boxes."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * (w - 1.0)
    cy = boxes[..., 1] + 0.5 * (h - 1.0)
    pcx = deltas[..., 0] * w + cx
    pcy = deltas[..., 1] * h + cy
    pw = torch.exp(deltas[..., 2]) * w
    ph = torch.exp(deltas[..., 3]) * h
    return torch.stack([pcx - 0.5 * (pw - 1.0), pcy - 0.5 * (ph - 1.0),
                        pcx + 0.5 * (pw - 1.0), pcy + 0.5 * (ph - 1.0)],
                       dim=-1)


def _grid_anchors(feat_h, feat_w, stride, scales, ratios, device):
    base = base_anchors(scales, ratios, stride).to(device)        # (A, 4)
    sx = torch.arange(feat_w, dtype=torch.float32, device=device) * stride
    sy = torch.arange(feat_h, dtype=torch.float32, device=device) * stride
    shift_y, shift_x = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([shift_x, shift_y, shift_x, shift_y],
                         dim=-1).reshape(-1, 1, 4)
    return (shifts + base[None, :, :]).reshape(-1, 4)


def _clip(x, hi):
    return torch.minimum(x.clamp(min=0), hi)


def proposal_candidates(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                        rpn_min_size, scales, ratios, feature_stride):
    """Proposal before its NMS: the ``rpn_pre_nms_top_n`` best decoded,
    clipped boxes of each image (N, pre_n, 4) and their scores (N, pre_n),
    -inf where a box is under ``rpn_min_size``."""
    n, a2, h, w = cls_prob.shape
    num_anchors = a2 // 2
    anchors = _grid_anchors(h, w, float(feature_stride), scales, ratios,
                            cls_prob.device)
    scores = cls_prob[:, num_anchors:].permute(0, 2, 3, 1).reshape(n, -1)
    deltas = bbox_pred.reshape(n, num_anchors, 4, h, w).permute(
        0, 3, 4, 1, 2).reshape(n, -1, 4)
    boxes = bbox_transform_inv(anchors[None], deltas)
    height, width, scale = (im_info[:, k:k + 1] for k in range(3))
    boxes = torch.stack([_clip(boxes[..., 0], width - 1.0),
                         _clip(boxes[..., 1], height - 1.0),
                         _clip(boxes[..., 2], width - 1.0),
                         _clip(boxes[..., 3], height - 1.0)], dim=-1)
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    ms = float(rpn_min_size) * scale
    valid = (ws >= ms) & (hs >= ms)
    scores = torch.where(valid, scores, torch.full_like(scores, -math.inf))
    pre_n = min(int(rpn_pre_nms_top_n), scores.shape[1])
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :pre_n], top_idx[:, :pre_n]
    return boxes.gather(1, top_idx[..., None].expand(-1, -1, 4)), top_scores


def _proposal_impl(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                   rpn_post_nms_top_n, threshold, rpn_min_size, scales,
                   ratios, feature_stride, output_score):
    n = cls_prob.shape[0]
    top_boxes, top_scores = proposal_candidates(
        cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n, rpn_min_size,
        scales, ratios, feature_stride)
    pre_n, post_n = top_scores.shape[1], int(rpn_post_nms_top_n)
    alive = nms(top_boxes, torch.zeros_like(top_scores),
                top_scores > -math.inf, pre_n, float(threshold),
                force_suppress=True)
    # the survivors first, each group in its score order
    keep = torch.sort((~alive).to(torch.uint8), dim=1,
                      stable=True).indices[:, :post_n]
    kept_alive = alive.gather(1, keep)
    kept_boxes = torch.where(kept_alive[..., None],
                             top_boxes.gather(1, keep[..., None].expand(
                                 -1, -1, 4)), torch.zeros(
                                     (), dtype=top_boxes.dtype,
                                     device=top_boxes.device))
    kept_scores = torch.where(kept_alive, top_scores.gather(1, keep),
                              torch.zeros((), dtype=top_scores.dtype,
                                          device=top_scores.device))
    idx = torch.arange(n, dtype=kept_boxes.dtype, device=kept_boxes.device)
    rois = torch.cat([idx[:, None, None].expand(-1, keep.shape[1], 1),
                      kept_boxes], dim=-1).reshape(-1, 5)
    if output_score:
        return rois, kept_scores.reshape(-1, 1)
    return rois


@register("_contrib_Proposal", nondiff_inputs=(0, 1, 2),
          num_outputs=lambda a: 2 if a.get("output_score", False) else 1)
def _proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
              rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
              scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
              feature_stride=16, output_score=False, iou_loss=False, **kw):
    """RPN proposals.  cls_prob (N, 2A, H, W); bbox_pred (N, 4A, H, W);
    im_info (N, 3) [height, width, scale].  Output rois
    (N * rpn_post_nms_top_n, 5) [batch index, x0, y0, x1, y1]."""
    return _proposal_impl(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                          rpn_post_nms_top_n, threshold, rpn_min_size,
                          _as_floats(scales), _as_floats(ratios),
                          feature_stride, output_score)


@register("_contrib_MultiProposal", nondiff_inputs=(0, 1, 2),
          num_outputs=lambda a: 2 if a.get("output_score", False) else 1)
def _multi_proposal(cls_prob, bbox_pred, im_info, **kw):
    """The batched Proposal (the same op here: it runs over the batch)."""
    return _proposal(cls_prob, bbox_pred, im_info, **kw)


def _psroi_pool(data, rois, spatial_scale, group_size, pooled_size,
                output_dim):
    """Position-sensitive ROI average pooling of every roi:
    data (N, D*g*g, H, W), rois (R, 5) -> (R, D, p, p)."""
    c, h, w = data.shape[1:]
    g, p = group_size, pooled_size
    dev, dt = data.device, rois.dtype
    x0, y0 = rois[:, 1] * spatial_scale, rois[:, 2] * spatial_scale
    x1, y1 = rois[:, 3] * spatial_scale, rois[:, 4] * spatial_scale
    bin_w = (x1 - x0).clamp(min=0.1) / p
    bin_h = (y1 - y0).clamp(min=0.1) / p
    # a fixed 2 x 2 grid of bilinear samples in each bin
    grid = (torch.arange(p, device=dev)[:, None]
            + torch.tensor([0.25, 0.75], dtype=torch.float32, device=dev)
            [None, :]).to(dt).reshape(-1)                             # (2p,)
    px = (x0[:, None] + grid[None, :] * bin_w[:, None]).clamp(0, w - 1.0)
    py = (y0[:, None] + grid[None, :] * bin_h[:, None]).clamp(0, h - 1.0)
    x_lo, y_lo = px.floor().long(), py.floor().long()
    x_hi, y_hi = (x_lo + 1).clamp(max=w - 1), (y_lo + 1).clamp(max=h - 1)
    fx, fy = px - x_lo, py - y_lo                                    # (R, 2p)
    b = rois[:, 0].long()[:, None, None]

    def gather(yi, xi):                                   # (R, C, 2p, 2p)
        return data[b, :, yi[:, :, None], xi[:, None, :]].permute(0, 3, 1, 2)

    wy0, wy1 = (1 - fy)[:, None, :, None], fy[:, None, :, None]
    wx0, wx1 = (1 - fx)[:, None, None, :], fx[:, None, None, :]
    v = (gather(y_lo, x_lo) * (wy0 * wx0) + gather(y_lo, x_hi) * (wy0 * wx1)
         + gather(y_hi, x_lo) * (wy1 * wx0) + gather(y_hi, x_hi) * (wy1 * wx1))
    r = rois.shape[0]
    v = v.reshape(r, c, p, 2, p, 2).mean(dim=(3, 5))                # (R,C,p,p)
    gi = torch.div(torch.arange(p, device=dev) * g, p, rounding_mode="floor")
    chan = ((torch.arange(output_dim, device=dev)[:, None, None] * g
             + gi[None, :, None]) * g + gi[None, None, :])          # (D,p,p)
    ii = torch.arange(p, device=dev)[None, :, None]
    jj = torch.arange(p, device=dev)[None, None, :]
    return v[:, chan, ii, jj]


@register("_contrib_PSROIPooling", nondiff_inputs=(1,))
def _psroi_pooling(data, rois, spatial_scale=1.0, output_dim=1,
                   pooled_size=1, group_size=0, **kw):
    """Position-sensitive ROI pooling.  data (N, D*g*g, H, W); rois
    (R, 5) [batch, x0, y0, x1, y1] -> (R, output_dim, p, p)."""
    group_size = int(group_size) or int(pooled_size)
    return _psroi_pool(data, rois, float(spatial_scale), group_size,
                       int(pooled_size), int(output_dim))


def bilinear_sample_chw(img, ys, xs):
    """Sample img (N, C, H, W) at float points ys/xs (N, ...) ->
    (N, C, ...): each point clamped to the image and the high index
    clamped apart, so an integer point samples exactly."""
    n, c, h, w = img.shape
    ys = ys.clamp(0.0, h - 1.0)
    xs = xs.clamp(0.0, w - 1.0)
    y0, x0 = ys.floor().long(), xs.floor().long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    fy, fx = (ys - y0)[:, None], (xs - x0)[:, None]
    flat = img.reshape(n, c, -1)
    shape = ys.shape[1:]

    def at(yy, xx):
        idx = (yy * w + xx).reshape(n, 1, -1).expand(-1, c, -1)
        return flat.gather(2, idx).reshape(n, c, *shape)

    return (at(y0, x0) * (1 - fy) * (1 - fx) + at(y0, x1) * (1 - fy) * fx
            + at(y1, x0) * fy * (1 - fx) + at(y1, x1) * fy * fx)


@register("_contrib_DeformableConvolution", attr_defaults={"no_bias": False})
def _deformable_convolution(data, offset, weight, *maybe_bias, kernel=(3, 3),
                            stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                            num_filter=0, num_group=1, num_deformable_group=1,
                            no_bias=False, workspace=1024, **kw):
    """Deformable convolution v1: data (N, Cin, H, W); offset
    (N, 2*dg*kh*kw, Ho, Wo), (dy, dx) pairs; weight (Cout, Cin/g, kh, kw)."""
    bias = None if (no_bias or not maybe_bias) else maybe_bias[0]
    kh, kw = (int(k) for k in kernel)
    sh, sw = (int(s) for s in stride)
    ph, pw = (int(p) for p in pad)
    dh, dw = (int(d) for d in dilate)
    n, cin, h, w = data.shape
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = int(num_deformable_group)
    cpg = cin // dg
    dev = data.device
    offs = offset.reshape(n, dg, kh, kw, 2, ho, wo)
    base_y = (torch.arange(ho, device=dev)[None, None, :, None] * sh - ph
              + torch.arange(kh, device=dev)[:, None, None, None] * dh)
    base_x = (torch.arange(wo, device=dev)[None, None, None, :] * sw - pw
              + torch.arange(kw, device=dev)[None, :, None, None] * dw)
    cols = []
    for gr in range(dg):
        ys = (base_y + offs[:, gr, :, :, 0]).to(torch.float32)  # (N,kh,kw,Ho,Wo)
        xs = (base_x + offs[:, gr, :, :, 1]).to(torch.float32)
        cols.append(bilinear_sample_chw(data[:, gr * cpg:(gr + 1) * cpg],
                                        ys, xs))
    col = torch.cat(cols, dim=1)                       # (N, Cin, kh, kw, Ho, Wo)
    cout, g = weight.shape[0], int(num_group)
    if g > 1:
        col_g = col.reshape(n, g, cin // g, kh, kw, ho * wo)
        w_g = weight.reshape(g, cout // g, cin // g, kh, kw)
        out = torch.einsum("ngckrx,gockr->ngox", col_g, w_g).reshape(
            n, cout, ho, wo)
    else:
        out = torch.einsum("nckrhw,ockr->nohw", col, weight)
    if bias is not None:
        out = out + bias[:, None, None]
    return out


@register("_contrib_DeformablePSROIPooling", nondiff_inputs=(1,))
def _deformable_psroi_pooling(data, rois, *maybe_trans, spatial_scale=1.0,
                              output_dim=1, group_size=1, pooled_size=1,
                              part_size=0, sample_per_part=1, trans_std=0.0,
                              no_trans=False, **kw):
    """Deformable PS ROI pooling: PSROIPooling of each roi shifted by the
    mean of its trans field (R, 2D, part, part) x trans_std x its extent;
    with ``no_trans`` (or no trans input) PSROIPooling itself."""
    group_size = int(group_size) or int(pooled_size)
    p, ss = int(pooled_size), float(spatial_scale)
    trans = None if (no_trans or not maybe_trans) else maybe_trans[0]
    if trans is not None:
        r = rois.shape[0]
        ps = int(part_size) or p
        rw = (rois[:, 3] - rois[:, 1]) * ss
        rh = (rois[:, 4] - rois[:, 2]) * ss
        ty = trans[:, 0::2].reshape(r, -1, ps, ps).mean(dim=1)
        tx = trans[:, 1::2].reshape(r, -1, ps, ps).mean(dim=1)
        dy = ty.mean(dim=(1, 2)) * float(trans_std) * rh
        dx = tx.mean(dim=(1, 2)) * float(trans_std) * rw
        rois = torch.stack([rois[:, 0], rois[:, 1] + dx / ss,
                            rois[:, 2] + dy / ss, rois[:, 3] + dx / ss,
                            rois[:, 4] + dy / ss], dim=1)
    return _psroi_pool(data, rois, ss, group_size, p, int(output_dim))
