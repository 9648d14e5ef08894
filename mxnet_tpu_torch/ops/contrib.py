"""Detection ops: the MultiBox family, box IoU, greedy NMS, bipartite
matching and the box codecs (SSD's half of ``mxnet_tpu/ops/contrib.py``;
ref: src/operator/contrib/ multibox_prior.cc, multibox_target.cc,
multibox_detection.cc, bounding_box.cc).

Plain functions on tensors, registered under the JAX package's names
and their ``_contrib_`` aliases, each the JAX op's arithmetic so that the
same inputs give the same rows, class ids and anchor order:

  * every shape is static: NMS returns all N rows, suppressed ones -1;
  * the serial cores (the force match of ``MultiBoxTarget``, greedy NMS,
    bipartite matching) are Python loops over a static count of device
    ops vectorised over the batch, as ``lax.fori_loop`` is under
    ``vmap``: no ``.item()``, ``.cpu()`` or host copy, so they run on the
    card and inside a captured CUDA graph;
  * ties break as in the JAX package: first-index ``argmax``/``argmin``,
    stable ascending ``argsort`` where it calls ``jnp.argsort``;
  * Python constants enter as float32 scalars (a weak-typed scalar in
    JAX), never as tensors built on the host.

Not ported here: ROI pooling and align, ``Proposal``, ``PSROIPooling``,
``boolean_mask``, FFT, ``BilinearResize2D`` and ``AdaptiveAvgPooling2D``
(ROADMAP queue A item 9).
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register_op

__all__ = ["box_iou", "multibox_prior", "multibox_target",
           "greedy_nms_keep", "multibox_detection", "decode_sorted",
           "box_nms",
           "bipartite_matching", "box_encode", "box_decode"]

# the row-recompute NMS branch past this many candidates, as in JAX
_NMS_MATRIX_MAX = 1024


def _f32(v) -> float:
    """A Python number rounded to float32, as JAX rounds a weak-typed
    scalar against a float32 array."""
    return float(np.float32(v))


def _corner_iou(a, b):
    """Pairwise IoU of corner boxes a (..., N, 4) and b (..., M, 4) ->
    (..., N, M)."""
    ax1, ay1, ax2, ay2 = (a[..., :, i:i + 1] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp_min(0.0) * (ay2 - ay1).clamp_min(0.0)
    area_b = (bx2 - bx1).clamp_min(0.0) * (by2 - by1).clamp_min(0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, 0.0)


def _center_to_corner(boxes):
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], -1)


def _corner_to_center(boxes):
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def _rows_at(i, n, device):
    """(B, n) mask of position i[b] in each row."""
    return torch.arange(n, device=device)[None, :] == i[:, None]


def _gather_rows(x, idx):
    """x (B, N, K) rows picked by idx (B, R) -> (B, R, K)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def box_iou(lhs, rhs, format="corner"):  # noqa: A002 — attr name
    """Pairwise IoU of two box sets [..., 4] -> [*lhs_batch, *rhs_batch]
    ('corner' x1,y1,x2,y2 or 'center' cx,cy,w,h)."""
    if format == "center":
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    out = _corner_iou(lhs.reshape(-1, 4), rhs.reshape(-1, 4))
    return out.reshape(tuple(lhs.shape[:-1]) + tuple(rhs.shape[:-1]))


def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes (1, h*w*k, 4) of a feature map: per pixel, every size
    at ratios[0], then sizes[0] at ratios[1:].  Bit for bit the JAX op:
    centres (arange + offset) * float32(step), step 1/h by default (the
    rounded reciprocal, not a division by h); half-widths s·sqrt(r)
    formed in float64, rounded to float32, then halved."""
    h, w = data.shape[-2], data.shape[-1]
    dev = data.device
    step_y = _f32(steps[0] if steps[0] > 0 else 1.0 / h)
    step_x = _f32(steps[1] if steps[1] > 0 else 1.0 / w)
    cy = (torch.arange(h, dtype=torch.float32, device=dev)
          + _f32(offsets[0])) * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev)
          + _f32(offsets[1])) * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    sizes, ratios = tuple(sizes), tuple(ratios)
    shapes = [(s, ratios[0]) for s in sizes] + \
        [(sizes[0], r) for r in ratios[1:]]
    half = [(_f32(s * np.sqrt(r)) / 2, _f32(s / np.sqrt(r)) / 2)
            for s, r in shapes]
    # per-anchor scalars: no tensor is built on the host
    boxes = torch.stack([torch.stack([cxg - hw, cyg - hh, cxg + hw,
                                      cyg + hh], -1) for hw, hh in half],
                        2)  # (h, w, k, 4)
    boxes = boxes.reshape(1, h * w * len(half), 4)
    return boxes.clamp(0.0, 1.0) if clip else boxes


def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD target assignment.  anchor (1, N, 4) corner; label (B, M, 5)
    [cls, x1, y1, x2, y2] padded with -1 rows; cls_pred (B, C+1, N), read
    for hard-negative mining when negative_mining_ratio > 0.  Returns
    (box_target (B, N*4), box_mask (B, N*4), cls_target (B, N)).

    An anchor is positive when its best IoU exceeds overlap_threshold or
    when the sequential bipartite force match gives it a ground truth:
    each of M rounds takes the single best (anchor, gt) pair left and
    retires both.  Hard negatives are anchors with best IoU below
    negative_mining_thresh, ranked by their background log-loss."""
    anchor, label, cls_pred = anchor.detach(), label.detach(), \
        cls_pred.detach()
    anchors = anchor.reshape(-1, 4)
    n = anchors.shape[0]
    b, m = label.shape[0], label.shape[1]
    dev = anchors.device
    va = [_f32(v) for v in variances]
    valid = label[:, :, 0] >= 0                          # (B, M)
    gt = label[:, :, 1:5]
    iou = torch.where(valid[:, None, :], _corner_iou(anchors, gt), -1.0)
    best_iou = iou.amax(dim=2)                           # (B, N)
    best_gt = torch.argmax(iou, dim=2)                   # first index
    matched = best_iou > overlap_threshold
    forced_gt = torch.zeros(b, n, dtype=torch.long, device=dev)
    forced = torch.zeros(b, n, dtype=torch.bool, device=dev)
    cur = iou
    for _ in range(m):
        flat = cur.reshape(b, -1)
        idx = torch.argmax(flat, dim=1)
        i, j = idx // m, idx % m
        good = torch.gather(flat, 1, idx[:, None])[:, 0] > 0.0
        row = _rows_at(i, n, dev) & good[:, None]        # (B, N)
        col = _rows_at(j, m, dev) & good[:, None]        # (B, M)
        forced_gt = torch.where(row, j[:, None], forced_gt)
        forced = forced | row
        cur = torch.where(row[:, :, None] | col[:, None, :], -1.0, cur)
    assigned = torch.where(forced, forced_gt, best_gt)
    pos = matched | forced
    gc = _corner_to_center(_gather_rows(gt, assigned))   # (B, N, 4)
    ac = _corner_to_center(anchors)
    tx = (gc[..., 0] - ac[:, 0]) / ac[:, 2] / va[0]
    ty = (gc[..., 1] - ac[:, 1]) / ac[:, 3] / va[1]
    tw = torch.log((gc[..., 2] / ac[:, 2]).clamp_min(1e-12)) / va[2]
    th = torch.log((gc[..., 3] / ac[:, 3]).clamp_min(1e-12)) / va[3]
    box_t = torch.where(pos[..., None], torch.stack([tx, ty, tw, th], -1),
                        0.0)
    box_m = pos[..., None].expand(b, n, 4).to(torch.float32)
    cls_t = torch.where(
        pos, torch.gather(label[:, :, 0], 1, assigned) + 1.0, 0.0)
    if negative_mining_ratio > 0:
        x = cls_pred
        e = torch.exp(x - x.amax(dim=1, keepdim=True))
        bg_prob = (e / e.sum(dim=1, keepdim=True))[:, 0]  # (B, N)
        neg_loss = -torch.log(bg_prob.clamp_min(1e-12))
        neg_cand = (~pos) & (best_iou < negative_mining_thresh)
        num_pos = pos.sum(dim=1)
        max_neg = torch.clamp_min(
            (num_pos.to(torch.float32) * _f32(negative_mining_ratio))
            .to(torch.int32), int(minimum_negative_samples))
        order = torch.argsort(torch.where(neg_cand, -neg_loss, float("inf")),
                              dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n, device=dev).expand(b, n))
        keep_neg = neg_cand & (rank < max_neg[:, None])
        cls_t = torch.where(pos, cls_t, torch.where(
            keep_neg, 0.0, _f32(ignore_label)))
    return box_t.reshape(b, -1), box_m.reshape(b, -1), cls_t


def greedy_nms_keep(boxes, scores, ids, thresh, force_suppress):
    """Greedy NMS over candidates sorted by score, descending: boxes (B,
    K, 4), scores (B, K), ids (B, K) -> keep mask (B, K).  Candidate i, if
    still kept, suppresses every later candidate of its class (of any
    class under force_suppress) whose IoU with it exceeds thresh; a score
    of 0 is never kept.  Up to 1024 candidates the K x K IoU matrix is
    formed once; past that each step forms its row, so memory stays
    O(B·K) (the JAX op's two branches)."""
    k = boxes.shape[1]
    dev = boxes.device
    later = torch.arange(k, device=dev)
    keep = scores > 0
    if k <= _NMS_MATRIX_MAX:
        sup = _corner_iou(boxes, boxes) > thresh
        if not force_suppress:
            sup = sup & (ids[:, :, None] == ids[:, None, :])
        for i in range(k):
            row = sup[:, i] & (later > i)
            keep = torch.where(keep[:, i:i + 1], keep & ~row, keep)
        return keep
    for i in range(k):
        row = (_corner_iou(boxes[:, i:i + 1], boxes)[:, 0] > thresh) & \
            (later > i)
        if not force_suppress:
            row = row & (ids == ids[:, i:i + 1])
        keep = torch.where(keep[:, i:i + 1], keep & ~row, keep)
    return keep


def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """Decode and per-class NMS.  cls_prob (B, C, N), loc_pred (B, N*4),
    anchor (1, N, 4).  Output (B, N, 6) [cls_id, score, x1, y1, x2, y2] in
    score order, suppressed rows -1; class id 0 is the first class after
    background_id.  nms_topk caps the NMS candidates only: rows past the
    cap come back -1."""
    b, n = cls_prob.shape[0], cls_prob.shape[2]
    topk = min(int(nms_topk), n) if nms_topk > 0 else n
    sb, ss, si = decode_sorted(cls_prob, loc_pred, anchor, clip, threshold,
                               background_id, variances)
    keep = greedy_nms_keep(sb[:, :topk], ss[:, :topk], si[:, :topk],
                           _f32(nms_threshold), force_suppress)
    if topk < n:
        keep = torch.cat([keep, keep.new_zeros(b, n - topk)], 1)
    out = torch.cat([si[..., None], ss[..., None], sb], -1)
    return torch.where(keep[..., None], out, -1.0)


def decode_sorted(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                  background_id=0, variances=(0.1, 0.1, 0.2, 0.2)):
    """MultiBoxDetection before its NMS: every anchor's decoded box (B, N,
    4), score (B, N; 0 at or below threshold) and class id (B, N), in
    score order, descending (a stable sort of -score)."""
    cls_prob, loc_pred, anchor = cls_prob.detach(), loc_pred.detach(), \
        anchor.detach()
    b, c, n = cls_prob.shape
    va = [_f32(v) for v in variances]
    ac = _corner_to_center(anchor.reshape(-1, 4))
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], 1) if c > 1 \
        else cls_prob
    score = fg.amax(dim=1)
    cls_id = torch.argmax(fg, dim=1).to(torch.float32)  # first index
    lp = loc_pred.reshape(b, -1, 4)
    cx = lp[..., 0] * va[0] * ac[:, 2] + ac[:, 0]
    cy = lp[..., 1] * va[1] * ac[:, 3] + ac[:, 1]
    w = torch.exp((lp[..., 2] * va[2]).clamp_max(10.0)) * ac[:, 2]
    h = torch.exp((lp[..., 3] * va[3]).clamp_max(10.0)) * ac[:, 3]
    boxes = _center_to_corner(torch.stack([cx, cy, w, h], -1))
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    score = torch.where(score > _f32(threshold), score, 0.0)
    order = torch.argsort(-score, dim=1, stable=True)
    return (_gather_rows(boxes, order), torch.gather(score, 1, order),
            torch.gather(cls_id, 1, order))


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=False,
            in_format="corner", out_format="corner"):
    """data (..., N, K) -> the same shape: rows in score order,
    suppressed rows and rows past ``topk`` -1 (ref: bounding_box.cc
    box_nms)."""
    data = data.detach()
    shape = data.shape
    n, k = shape[-2], shape[-1]
    rows = data.reshape(-1, n, k)
    cap = int(topk) if topk > 0 else n
    cs = slice(coord_start, coord_start + 4)
    boxes = rows[..., cs]
    if in_format == "center":
        boxes = _center_to_corner(boxes)
    scores = rows[..., score_index]
    ids = rows[..., id_index] if id_index >= 0 else torch.zeros_like(scores)
    scores = torch.where(scores > _f32(valid_thresh), scores, 0.0)
    order = torch.argsort(-scores, dim=1, stable=True)
    keep = greedy_nms_keep(
        _gather_rows(boxes, order)[:, :cap],
        torch.gather(scores, 1, order)[:, :cap],
        torch.gather(ids, 1, order)[:, :cap], _f32(overlap_thresh),
        force_suppress)
    if cap < n:
        keep = torch.cat([keep, keep.new_zeros(keep.shape[0], n - cap)], 1)
    out = _gather_rows(rows, order)
    if out_format != in_format:
        conv = _corner_to_center if out_format == "center" \
            else _center_to_corner
        out = torch.cat([out[..., :coord_start], conv(out[..., cs]),
                         out[..., coord_start + 4:]], -1)
    return torch.where(keep[..., None], out, -1.0).reshape(shape)


def bipartite_matching(dist, is_ascend=False, threshold=1e-12, topk=-1):
    """Greedy global bipartite matching on dist (..., N, M): each round
    takes the best pair left (the largest, or the smallest when
    is_ascend) if it passes threshold and retires its row and column.
    Returns (row_match (..., N), col_match (..., M)), -1 where
    unmatched."""
    dist = dist.detach()
    shape = dist.shape
    n, m = shape[-2], shape[-1]
    d = dist.reshape(-1, n, m)
    b, dev = d.shape[0], d.device
    steps = min(n, m) if topk <= 0 else min(topk, n, m)
    sign = 1.0 if is_ascend else -1.0
    d = sign * d
    row = torch.full((b, n), -1.0, device=dev)
    col = torch.full((b, m), -1.0, device=dev)
    thr = _f32(threshold)
    for _ in range(steps):
        flat = d.reshape(b, -1)
        idx = torch.argmin(flat, dim=1)
        i, j = idx // m, idx % m
        v = torch.gather(flat, 1, idx[:, None])[:, 0]
        orig = sign * v
        good = torch.isfinite(v) & ((orig <= thr) if is_ascend
                                    else (orig >= thr))
        ri = _rows_at(i, n, dev) & good[:, None]
        cj = _rows_at(j, m, dev) & good[:, None]
        row = torch.where(ri, j[:, None].to(torch.float32), row)
        col = torch.where(cj, i[:, None].to(torch.float32), col)
        d = torch.where(ri[:, :, None] | cj[:, None, :], float("inf"), d)
    return row.reshape(shape[:-2] + (n,)), col.reshape(shape[:-2] + (m,))


def box_encode(samples, matches, anchors, refs, means=None, stds=None):
    """Matched ground truths against anchors as (dx, dy, dw, dh) targets
    plus a mask (ref: box_encode).  samples (B, N) in {-1, 0, 1}; matches
    (B, N) gt indices; anchors (B, N, 4) corner; refs (B, M, 4).  Default
    stds (0.1, 0.1, 0.2, 0.2)."""
    means = [_f32(v) for v in (means if means is not None else (0.0,) * 4)]
    stds = [_f32(v) for v in (stds if stds is not None
                              else (0.1, 0.1, 0.2, 0.2))]
    idx = matches.detach().to(torch.int32).long().clamp(0, refs.shape[1] - 1)
    g = _gather_rows(refs.detach(), idx)
    a = anchors.detach()
    ax, ay = (a[..., 0] + a[..., 2]) / 2, (a[..., 1] + a[..., 3]) / 2
    aw, ah = a[..., 2] - a[..., 0], a[..., 3] - a[..., 1]
    gx, gy = (g[..., 0] + g[..., 2]) / 2, (g[..., 1] + g[..., 3]) / 2
    gw, gh = g[..., 2] - g[..., 0], g[..., 3] - g[..., 1]
    awc, ahc = aw.clamp_min(1e-12), ah.clamp_min(1e-12)
    t = [(gx - ax) / awc, (gy - ay) / ahc,
         torch.log(gw.clamp_min(1e-12) / awc),
         torch.log(gh.clamp_min(1e-12) / ahc)]
    t = torch.stack([(v - mu) / sd for v, mu, sd in zip(t, means, stds)], -1)
    valid = (samples.detach() > 0.5)[..., None].to(torch.float32)
    return t * valid, valid.expand(t.shape)


def box_decode(data, anchors, std0=1.0, std1=1.0, std2=1.0, std3=1.0,
               clip=-1.0, format="corner"):  # noqa: A002 — attr name
    """Invert box_encode: deltas (B, N, 4) and anchors (1|B, N, 4) ->
    corner boxes, clipped to [0, clip] when clip > 0."""
    data, anchors = data.detach(), anchors.detach()
    a = _corner_to_center(anchors) if format == "corner" else anchors
    ax, ay, aw, ah = a.unbind(-1)
    cx = data[..., 0] * _f32(std0) * aw + ax
    cy = data[..., 1] * _f32(std1) * ah + ay
    w = torch.exp(data[..., 2] * _f32(std2)) * aw
    h = torch.exp(data[..., 3] * _f32(std3)) * ah
    out = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if clip is not None and clip > 0:
        out = out.clamp(0.0, clip)
    return out


for _name, _fn, _alias in (
        ("box_iou", box_iou, "_contrib_box_iou"),
        ("MultiBoxPrior", multibox_prior, "_contrib_MultiBoxPrior"),
        ("MultiBoxTarget", multibox_target, "_contrib_MultiBoxTarget"),
        ("MultiBoxDetection", multibox_detection,
         "_contrib_MultiBoxDetection"),
        ("box_nms", box_nms, "_contrib_box_nms"),
        ("bipartite_matching", bipartite_matching,
         "_contrib_bipartite_matching"),
        ("_contrib_box_encode", box_encode, "box_encode"),
        ("_contrib_box_decode", box_decode, "box_decode")):
    register_op(_name, aliases=(_alias,), differentiable=False)(_fn)
