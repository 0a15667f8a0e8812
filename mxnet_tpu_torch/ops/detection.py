"""Detection operators: the port of ``mxnet_tpu/ops/detection.py``.

``box_iou``, ``box_nms`` (alias ``box_non_maximum_suppression``),
``bipartite_matching``, ``MultiBoxPrior``, ``MultiBoxTarget``,
``MultiBoxDetection`` and ``ROIAlign`` (alias ``ROIAlign``), registered
under the JAX package's names (``_contrib_*``). Where the JAX package
vmaps a per-image function over the batch, these functions take the batch
dimension directly; the suppression loop is :func:`.nms.nms_keep` (the
hand-written CUDA kernel on the card), called once per batch.

Data-dependent work (the stable sorts, the greedy matchings, the top-k
cut) is plain PyTorch on the tensors' device, with no read back to the
host: a greedy matching is a loop of a fixed number of device steps.
``MultiBoxTarget`` and ``bipartite_matching`` have a shape rule of their
own for ``meta`` tensors (symbolic shape inference), since their matching
loops read values; the NMS dispatcher returns an empty mask there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ._common import ROI_CHUNK, _clip, _div, _floats, _roi_batch
from .nms import nms_keep
from .registry import REQUIRED, AttrDict, register

__all__ = []


_FMT = {"corner": 0, "center": 1, 0: 0, 1: 1, "0": 0, "1": 1}


def _to_corner(boxes, fmt):
    if _FMT[fmt] == 0:
        return boxes
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def _from_corner(boxes, fmt):
    if _FMT[fmt] == 0:
        return boxes
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                       dim=-1)


def _pair_iou(a, b):
    """IoU matrix between corner boxes a (..., N, 4) and b (..., M, 4)."""
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    iw = (torch.minimum(a[..., 2], b[..., 2])
          - torch.maximum(a[..., 0], b[..., 0])).clamp_min(0.0)
    ih = (torch.minimum(a[..., 3], b[..., 3])
          - torch.maximum(a[..., 1], b[..., 1])).clamp_min(0.0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]).clamp_min(0.0) * \
        (a[..., 3] - a[..., 1]).clamp_min(0.0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0.0) * \
        (b[..., 3] - b[..., 1]).clamp_min(0.0)
    return inter / torch.clamp_min(area_a + area_b - inter, 1e-12)


# ---------------------------------------------------------------------------
# box_iou
# ---------------------------------------------------------------------------


@register("_contrib_box_iou", params={"format": (str, "corner")},
          inputs=("lhs", "rhs"))
def _box_iou(attrs, lhs, rhs):
    """IoU between every pair (reference bounding_box.cc box_iou)."""
    return _pair_iou(_to_corner(lhs, attrs.format),
                     _to_corner(rhs, attrs.format))


# ---------------------------------------------------------------------------
# box_nms
# ---------------------------------------------------------------------------


_NMS_PARAMS = {
    "overlap_thresh": (float, 0.5),
    "valid_thresh": (float, 0.0),
    "topk": (int, -1),
    "coord_start": (int, 2),
    "score_index": (int, 1),
    "id_index": (int, -1),
    "force_suppress": (bool, False),
    "in_format": (str, "corner"),
    "out_format": (str, "corner"),
}


def _nms_batch(flat, attrs):
    """NMS over a batch of (N, K) box tables, (B, N, K) -> (B, N, K):
    suppressed rows -1, the rest sorted by descending score (the JAX
    ``_nms_one``, one image per row of the batch)."""
    b, n, _ = flat.shape
    cs, si, ii = attrs.coord_start, attrs.score_index, attrs.id_index
    scores = flat[..., si]
    valid = scores > attrs.valid_thresh
    # jnp.argsort is stable: ties keep their input order here too
    key = -torch.where(valid, scores, torch.full_like(scores, -np.inf))
    order = torch.argsort(key, dim=-1, stable=True)
    sorted_rows = torch.gather(
        flat, 1, order[..., None].expand(b, n, flat.shape[-1]))
    boxes = _to_corner(sorted_rows[..., cs:cs + 4], attrs.in_format)
    cls_ids = sorted_rows[..., ii] if ii >= 0 \
        else torch.full((b, n), -1.0, dtype=flat.dtype, device=flat.device)
    valid_sorted = torch.gather(valid, 1, order)
    if attrs.topk > 0:
        valid_sorted = valid_sorted & (
            torch.arange(n, device=flat.device) < attrs.topk)
    keep = nms_keep(boxes, cls_ids, valid_sorted, attrs.overlap_thresh,
                    attrs.force_suppress or ii < 0)
    out_rows = sorted_rows
    if attrs.out_format != attrs.in_format:
        out_rows = torch.cat([sorted_rows[..., :cs],
                              _from_corner(boxes, attrs.out_format),
                              sorted_rows[..., cs + 4:]], dim=-1)
    return torch.where(keep[..., None], out_rows,
                       torch.full_like(out_rows, -1.0))


@register("_contrib_box_nms", params=_NMS_PARAMS,
          aliases=("_contrib_box_non_maximum_suppression",))
def _box_nms(attrs, data):
    """Non-maximum suppression (reference bounding_box.cc BoxNMSForward).
    Output keeps the input shape; suppressed and invalid entries are -1;
    survivors are sorted by score."""
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:]))
    return _nms_batch(flat, attrs).reshape(shape)


# ---------------------------------------------------------------------------
# bipartite_matching
# ---------------------------------------------------------------------------


@register("_contrib_bipartite_matching",
          params={"is_ascend": (bool, False), "threshold": (float, REQUIRED),
                  "topk": (int, -1)},
          num_outputs=2)
def _bipartite_matching(attrs, data):
    """Greedy bipartite matching on a score matrix (reference
    bounding_box.cc BipartiteMatchingForward): repeatedly take the globally
    best unmatched pair while it passes ``threshold``. Returns (row_match,
    col_match) with -1 for unmatched. ``min(limit, m)`` steps over the
    whole batch, each a few device operations (the JAX op's
    ``lax.fori_loop``); the outputs carry no gradient."""
    shape = tuple(data.shape)
    n, m = shape[-2], shape[-1]
    if data.device.type == "meta":  # shape rule: the loop reads values
        return (torch.empty(shape[:-1], dtype=data.dtype, device="meta"),
                torch.empty(shape[:-2] + (m,), dtype=data.dtype,
                            device="meta"))
    mat = data.detach().reshape(-1, n * m).clone()
    nb = mat.shape[0]
    dev = mat.device
    sign = 1.0 if attrs.is_ascend else -1.0
    limit = n if attrs.topk < 0 else min(attrs.topk, n)
    fill = torch.full((), np.inf * sign, dtype=mat.dtype, device=dev)
    batch = torch.arange(nb, device=dev)
    cell = torch.arange(n * m, device=dev)
    row_of, col_of = cell // m, cell % m
    row = torch.full((nb, n), -1.0, dtype=data.dtype, device=dev)
    col = torch.full((nb, m), -1.0, dtype=data.dtype, device=dev)
    for _ in range(min(limit, m)):
        idx = torch.argmin(sign * mat, dim=1)       # the first best pair
        r, c = idx // m, idx % m
        v = mat[batch, idx]
        ok = (v <= attrs.threshold) if attrs.is_ascend \
            else (v >= attrs.threshold)
        row[batch, r] = torch.where(ok, c.to(row.dtype), row[batch, r])
        col[batch, c] = torch.where(ok, r.to(col.dtype), col[batch, c])
        cut = ((row_of[None] == r[:, None]) | (col_of[None] == c[:, None])) \
            & ok[:, None]
        mat = torch.where(cut, fill, mat)
    return row.reshape(shape[:-1]), col.reshape(shape[:-2] + (m,))


# ---------------------------------------------------------------------------
# MultiBoxPrior
# ---------------------------------------------------------------------------


@register("_contrib_MultiBoxPrior",
          params={"sizes": (_floats, (1.0,)), "ratios": (_floats, (1.0,)),
                  "clip": (bool, False), "steps": (_floats, (-1.0, -1.0)),
                  "offsets": (_floats, (0.5, 0.5))},
          aliases=("MultiBoxPrior",))
def _multibox_prior(attrs, data):
    """Anchor boxes per feature-map location (reference
    multibox_prior.cc:40-78). Output (1, H*W*A, 4); it depends on the
    input's shape only, so it carries no gradient."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    sizes, ratios = attrs.sizes, attrs.ratios
    step_y = attrs.steps[0] if attrs.steps[0] > 0 else 1.0 / h
    step_x = attrs.steps[1] if attrs.steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=torch.float32, device=dev)
          + attrs.offsets[0]) * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev)
          + attrs.offsets[1]) * step_x
    # per-location half-extents, order: sizes first (ratio 1), then
    # ratios[1:] at sizes[0] (reference multibox_prior.cc:46-69)
    half = [(s * h / w / 2.0, s / 2.0) for s in sizes]
    for r in ratios[1:]:
        sr = float(np.sqrt(r))
        half.append((sizes[0] * h / w * sr / 2.0, sizes[0] / sr / 2.0))
    hw = torch.tensor([p[0] for p in half], dtype=torch.float32, device=dev)
    hh = torch.tensor([p[1] for p in half], dtype=torch.float32, device=dev)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    cyg = cyg[:, :, None]
    cxg = cxg[:, :, None]
    out = torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh], dim=-1)
    out = out.reshape(1, h * w * len(half), 4)
    if attrs.clip:
        out = out.clamp(0.0, 1.0)
    return out


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------


def _encode_loc(anchors, gt, variances):
    """SSD box encoding (reference multibox_target.cc TargetEncoding);
    anchors (N, 4), gt (B, N, 4)."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) / 2
    ay = (anchors[:, 1] + anchors[:, 3]) / 2
    gw = (gt[..., 2] - gt[..., 0]).clamp_min(1e-12)
    gh = (gt[..., 3] - gt[..., 1]).clamp_min(1e-12)
    gx = (gt[..., 0] + gt[..., 2]) / 2
    gy = (gt[..., 1] + gt[..., 3]) / 2
    v0, v1, v2, v3 = variances
    return torch.stack([
        (gx - ax) / aw.clamp_min(1e-12) / v0,
        (gy - ay) / ah.clamp_min(1e-12) / v1,
        torch.log(gw / aw.clamp_min(1e-12)) / v2,
        torch.log(gh / ah.clamp_min(1e-12)) / v3,
    ], dim=-1)


@register("_contrib_MultiBoxTarget",
          params={"overlap_threshold": (float, 0.5),
                  "ignore_label": (float, -1.0),
                  "negative_mining_ratio": (float, -1.0),
                  "negative_mining_thresh": (float, 0.5),
                  "minimum_negative_samples": (int, 0),
                  "variances": (_floats, (0.1, 0.1, 0.2, 0.2))},
          inputs=("anchor", "label", "cls_pred"), num_outputs=3)
def _multibox_target(attrs, anchor, label, cls_pred):
    """Training targets for SSD (reference multibox_target.cc): greedy
    bipartite anchor-GT matching, then per-anchor threshold matching,
    encoded location targets, and hard-negative mining ranked by each
    anchor's max non-background class score. Outputs loc_target
    (B, N*4), loc_mask (B, N*4), cls_target (B, N); none carries a
    gradient (the JAX targets are not differentiable either)."""
    anchors = anchor.reshape(-1, 4)
    n = anchors.shape[0]
    bsz, m = label.shape[0], label.shape[1]
    if anchor.device.type == "meta":  # shape rule: the loop reads values
        def empty(*shape):
            return torch.empty(shape, dtype=anchor.dtype, device="meta")

        return empty(bsz, n * 4), empty(bsz, n * 4), empty(bsz, n)
    anchors = anchors.detach()
    label = label.detach()
    pred = cls_pred.detach()
    dev = anchors.device
    rows = torch.arange(bsz, device=dev)

    gt_valid = label[..., 0] >= 0                            # (B, M)
    gt_boxes = label[..., 1:5]                               # (B, M, 4)
    iou = torch.where(gt_valid[:, None, :],
                      _pair_iou(anchors, gt_boxes),
                      torch.zeros((), device=dev))           # (B, N, M)

    # greedy bipartite: the best anchor for each gt, globally ordered
    mat = iou.clone()
    match = torch.full((bsz, n), -1, dtype=torch.int64, device=dev)
    for _ in range(m):
        idx = torch.argmax(mat.reshape(bsz, -1), dim=1)
        a, g = idx // m, idx % m
        ok = mat[rows, a, g] > 1e-12
        match[rows, a] = torch.where(ok, g, match[rows, a])
        row_a = torch.zeros((bsz, n, 1), dtype=torch.bool, device=dev)
        row_a[rows, a] = True
        col_g = torch.zeros((bsz, 1, m), dtype=torch.bool, device=dev)
        col_g[rows, 0, g] = True
        cut = (row_a | col_g) & ok[:, None, None]
        mat = torch.where(cut, torch.full_like(mat, -1.0), mat)

    # threshold matching for the rest
    best_iou, best_gt = torch.max(iou, dim=2)
    thresh_ok = (match < 0) & (best_iou >= attrs.overlap_threshold)
    match = torch.where(thresh_ok, best_gt, match)
    matched = match >= 0
    safe = match.clamp_min(0)

    gt_of = torch.gather(gt_boxes, 1, safe[..., None].expand(bsz, n, 4))
    loc_t = _encode_loc(anchors, gt_of, attrs.variances)
    loc_t = torch.where(matched[..., None], loc_t,
                        torch.zeros((), device=dev)).reshape(bsz, -1)
    loc_m = matched[..., None].expand(bsz, n, 4).to(anchors.dtype) \
        .reshape(bsz, -1)

    cls_of = torch.gather(label[..., 0], 1, safe)
    cls_t = torch.where(matched, cls_of + 1.0, torch.zeros((), device=dev))
    if attrs.negative_mining_ratio > 0:
        num_pos = matched.sum(dim=1, keepdim=True)
        max_neg = torch.clamp_min(
            (attrs.negative_mining_ratio * num_pos.float()).to(torch.int64),
            attrs.minimum_negative_samples)
        neg_cand = ~matched & (best_iou < attrs.negative_mining_thresh)
        # rank negatives by max non-background confidence (hardest first)
        conf = pred[:, 1:, :].amax(dim=1) if pred.shape[1] > 1 \
            else pred[:, 0]
        score = torch.where(neg_cand, conf, torch.full_like(conf, -np.inf))
        order = torch.argsort(-score, dim=1, stable=True)
        neg_rank = torch.empty_like(order)
        neg_rank.scatter_(1, order, torch.arange(n, device=dev)
                          .expand(bsz, n).contiguous())
        keep_neg = neg_cand & (neg_rank < max_neg)
        cls_t = torch.where(matched | keep_neg, cls_t,
                            torch.full_like(cls_t, attrs.ignore_label))
    return loc_t, loc_m, cls_t


# ---------------------------------------------------------------------------
# MultiBoxDetection
# ---------------------------------------------------------------------------


@register("_contrib_MultiBoxDetection",
          params={"clip": (bool, True), "threshold": (float, 0.01),
                  "background_id": (int, 0), "nms_threshold": (float, 0.5),
                  "force_suppress": (bool, False),
                  "variances": (_floats, (0.1, 0.1, 0.2, 0.2)),
                  "nms_topk": (int, -1)},
          inputs=("cls_prob", "loc_pred", "anchor"))
def _multibox_detection(attrs, cls_prob, loc_pred, anchor):
    """Decode + per-class NMS (reference multibox_detection.cc). Output
    (B, N, 6): [class_id, score, xmin, ymin, xmax, ymax]; invalid entries
    -1. class_id skips the background class. Not differentiable: the
    inputs are detached, as the JAX op stops their gradients."""
    cls_prob = cls_prob.detach()
    loc_pred = loc_pred.detach()
    anchors = anchor.detach().reshape(-1, 4)
    b, _, n = cls_prob.shape
    if anchors.shape[0] != n or loc_pred.shape[-1] != n * 4:
        raise MXNetError(
            "MultiBoxDetection: cls_prob has %d anchors but anchor/loc_pred "
            "carry %d/%d" % (n, anchors.shape[0], loc_pred.shape[-1] // 4))
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) / 2
    ay = (anchors[:, 1] + anchors[:, 3]) / 2
    v0, v1, v2, v3 = attrs.variances

    p = loc_pred.reshape(b, n, 4)
    ox = p[..., 0] * v0 * aw + ax
    oy = p[..., 1] * v1 * ah + ay
    hw = torch.exp(p[..., 2] * v2) * aw / 2
    hh = torch.exp(p[..., 3] * v3) * ah / 2
    boxes = torch.stack([ox - hw, oy - hh, ox + hw, oy + hh], dim=-1)
    if attrs.clip:
        boxes = boxes.clamp(0.0, 1.0)
    bg = attrs.background_id
    masked = cls_prob.clone()
    masked[:, bg, :] = -1.0
    score, best = torch.max(masked, dim=1)
    cls_id = torch.where(best > bg, best - 1, best).to(cls_prob.dtype)
    valid = score > attrs.threshold
    cls_id = torch.where(valid, cls_id, torch.full_like(cls_id, -1.0))
    score = torch.where(valid, score, torch.full_like(score, -1.0))
    table = torch.cat([cls_id[..., None], score[..., None], boxes], dim=-1)
    nms_attrs = AttrDict(
        overlap_thresh=attrs.nms_threshold, valid_thresh=0.0,
        topk=attrs.nms_topk, coord_start=2, score_index=1, id_index=0,
        force_suppress=attrs.force_suppress, in_format="corner",
        out_format="corner")
    return _nms_batch(table, nms_attrs)


# ---------------------------------------------------------------------------
# ROIAlign
# ---------------------------------------------------------------------------

@register("_contrib_ROIAlign",
          params={"pooled_size": (tuple, REQUIRED),
                  "spatial_scale": (float, REQUIRED),
                  "sample_ratio": (int, -1)},
          inputs=("data", "rois"), aliases=("ROIAlign",))
def _roi_align(attrs, data, rois):
    """RoI Align with bilinear sampling (reference roi_align.cc, Mask R-CNN
    semantics: no coordinate rounding). rois (R, 5) = [batch_idx, x1, y1,
    x2, y2]; output (R, C, PH, PW); differentiable in data and rois.

    Kept deviation, the JAX package's: with ``sample_ratio <= 0`` the
    reference adapts the tap grid to each RoI; this op, as the JAX one,
    takes a fixed 2 x 2 grid per bin. The taps are separable (a row and a
    column index a RoI), gathered ROI_CHUNK RoIs at a time. Peak: at 7 x 7
    bins of 2 x 2 taps over 512 channels one chunk's (ROI_CHUNK, C, 14, 14)
    tap block is 12.8 MB, and a few of them (four taps and their blends)
    are alive at once: over 300 RoIs on (1, 512, 37, 62) the forward's
    peak was 98 MB on an NVIDIA H100 80GB HBM3 (700 W)."""
    ph, pw = attrs.pooled_size
    sr = attrs.sample_ratio if attrs.sample_ratio > 0 else 2
    b, c, h, w = data.shape
    dev, dt = data.device, data.dtype
    one = torch.ones((), dtype=rois.dtype, device=dev)
    tap_y = torch.arange(ph * sr, dtype=torch.float32, device=dev) + 0.5
    tap_x = torch.arange(pw * sr, dtype=torch.float32, device=dev) + 0.5
    bi_all = _roi_batch(rois, data)
    outs = []
    for lo in range(0, rois.shape[0], ROI_CHUNK):
        rr = rois[lo:lo + ROI_CHUNK]
        bi = bi_all[lo:lo + ROI_CHUNK]
        x1, y1, x2, y2 = (rr[:, i] * attrs.spatial_scale for i in range(1, 5))
        rw = torch.maximum(x2 - x1, one)
        rh = torch.maximum(y2 - y1, one)
        bin_w = _div(rw, pw)
        bin_h = _div(rh, ph)
        gy = y1[:, None] + tap_y[None] * _div(bin_h, sr)[:, None]  # (r,PH*sr)
        gx = x1[:, None] + tap_x[None] * _div(bin_w, sr)[:, None]  # (r,PW*sr)
        y0 = _clip(torch.floor(gy), 0, h - 1)
        x0 = _clip(torch.floor(gx), 0, w - 1)
        y1i = _clip(y0 + 1, 0, h - 1).long()
        x1i = _clip(x0 + 1, 0, w - 1).long()
        y0i, x0i = y0.long(), x0.long()
        ly = _clip(gy - y0, 0.0, 1.0)[:, None, :, None]
        lx = _clip(gx - x0, 0.0, 1.0)[:, None, None, :]
        bsel = bi[:, None, None]

        def tap(yi, xi):
            # (r, Sy, Sx, C) by advanced indexing, channels back second
            return data[bsel, :, yi[:, :, None], xi[:, None, :]] \
                .permute(0, 3, 1, 2)

        top = tap(y0i, x0i) * (1 - lx) + tap(y0i, x1i) * lx
        bot = tap(y1i, x0i) * (1 - lx) + tap(y1i, x1i) * lx
        samp = top * (1 - ly) + bot * ly                   # (r, C, Sy, Sx)
        outs.append(samp.reshape(-1, c, ph, sr, pw, sr).mean(dim=(3, 5)))
    if not outs:
        return torch.zeros((0, c, ph, pw), dtype=dt, device=dev)
    return torch.cat(outs, dim=0)
