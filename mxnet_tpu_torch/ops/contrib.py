"""Contrib ops: detection (the MultiBox family, box IoU, greedy NMS,
bipartite matching, the box codecs), the R-CNN family (Proposal and
MultiProposal, ROIPooling, ROIAlign, PSROIPooling) and the vision ops
(BilinearResize2D, AdaptiveAvgPooling2D, boolean_mask, fft/ifft):
``mxnet_tpu/ops/contrib.py``'s ops (ref: src/operator/contrib/).

Plain functions on tensors, registered under the JAX package's names
and their ``_contrib_`` aliases, each the JAX op's arithmetic so that the
same inputs give the same rows, class ids and anchor order:

  * every shape is static (``boolean_mask`` aside): NMS returns all N
    rows, suppressed ones -1;
  * the serial cores (the force match of ``MultiBoxTarget``, bipartite
    matching) are Python loops over a static count of device ops
    vectorised over the batch, as ``lax.fori_loop`` is under ``vmap``:
    no ``.item()``, ``.cpu()`` or host copy, so they run on the card and
    inside a captured CUDA graph;
  * greedy NMS (``MultiBoxDetection``, ``box_nms``, ``Proposal``) runs
    the CUDA kernel of ``csrc/nms.cu`` on CUDA tensors and the JAX op's
    loop (:func:`greedy_nms_keep_ref`) on CPU tensors;
  * ties break as in the JAX package: first-index ``argmax``/``argmin``,
    stable sorts where it calls ``jnp.argsort`` or ``lax.top_k``;
  * Python constants enter as float32 scalars (a weak-typed scalar in
    JAX), never as tensors built on the host, and a division by one is
    by a 0-d tensor (``_divc``);
  * the ROI ops gather each bin's positions (the widest bin read to the
    host: they run eagerly) and reduce them as the JAX op's masks do, in
    chunks of rois; they and the resize and pooling ops carry their
    gradients through autograd.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import _kernels
from ..base import MXNetError
from .registry import register_op

__all__ = ["box_iou", "multibox_prior", "multibox_target",
           "greedy_nms_keep", "greedy_nms_keep_ref", "nms_launch_count",
           "reset_nms_launch_count", "nms_loop_runs", "reset_nms_loop_runs",
           "multibox_detection", "decode_sorted", "box_nms",
           "bipartite_matching", "box_encode", "box_decode", "roi_pooling",
           "psroi_pooling", "roi_align", "boolean_mask", "fft", "ifft",
           "proposal_candidates", "proposal", "bilinear_resize2d",
           "adaptive_avg_pooling2d"]

# the row-recompute NMS branch past this many candidates, as in JAX
_NMS_MATRIX_MAX = 1024
_NMS_NAME = "greedy_nms"
# the kernel's element types (csrc/nms.cu's `dtype` codes)
_NMS_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
               torch.float64: 3}


def _f32(v) -> float:
    """A Python number rounded to float32, as JAX rounds a weak-typed
    scalar against a float32 array."""
    return float(np.float32(v))


def _corner_iou(a, b, off=0.0):
    """Pairwise IoU of corner boxes a (..., N, 4) and b (..., M, 4) ->
    (..., N, M).  ``off`` = 1.0 is the legacy +1 pixel convention
    (Proposal's NMS): every extent is ``hi - lo + off`` before its clamp
    at 0."""
    def extent(hi, lo):
        d = hi - lo
        return (d + off if off else d).clamp_min(0.0)

    ax1, ay1, ax2, ay2 = (a[..., :, i:i + 1] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = extent(torch.minimum(ax2, bx2), torch.maximum(ax1, bx1))
    ih = extent(torch.minimum(ay2, by2), torch.maximum(ay1, by1))
    inter = iw * ih
    area_a = extent(ax2, ax1) * extent(ay2, ay1)
    area_b = extent(bx2, bx1) * extent(by2, by1)
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


def greedy_nms_keep(boxes, scores, ids, thresh, force_suppress, off=0.0):
    """Greedy NMS over candidates sorted by score, descending: boxes (B,
    K, 4), scores (B, K), ids (B, K) -> keep mask (B, K).  Candidate i, if
    still kept, suppresses every later candidate of its class (of any
    class under force_suppress) whose IoU (with the extent offset
    ``off``) exceeds thresh; a score <= 0 is never kept.  On CUDA tensors
    the kernel of ``csrc/nms.cu`` (boxes of float32, float16, bfloat16 or
    float64, or it raises), on CPU tensors :func:`greedy_nms_keep_ref`."""
    if boxes.device.type == "cuda":
        return _nms_launch(boxes, scores, ids, thresh, force_suppress, off)
    return greedy_nms_keep_ref(boxes, scores, ids, thresh, force_suppress,
                               off)


# runs of the plain Python loop by device type: the card's detection paths
# go through the kernel, so the loop's "cuda" count stays at 0 there
_LOOP_RUNS = {}


def nms_loop_runs() -> dict:
    """Runs of :func:`greedy_nms_keep_ref` by device type."""
    return dict(_LOOP_RUNS)


def reset_nms_loop_runs() -> None:
    _LOOP_RUNS.clear()


def nms_launch_count() -> int:
    return _kernels.launch_count(_NMS_NAME)


def reset_nms_launch_count() -> None:
    _kernels.reset_launch_count(_NMS_NAME)


def greedy_nms_keep_ref(boxes, scores, ids, thresh, force_suppress,
                        off=0.0):
    """The plain version: the JAX op's loop, one step a candidate.  Up to
    1024 candidates the K x K IoU matrix is formed once; past that each
    step forms its row, so memory stays O(B·K) (the JAX op's two
    branches)."""
    dev = boxes.device
    _LOOP_RUNS[dev.type] = _LOOP_RUNS.get(dev.type, 0) + 1
    k = boxes.shape[1]
    later = torch.arange(k, device=dev)
    keep = scores > 0
    if k <= _NMS_MATRIX_MAX:
        sup = _corner_iou(boxes, boxes, off) > thresh
        if not force_suppress:
            sup = sup & (ids[:, :, None] == ids[:, None, :])
        for i in range(k):
            row = sup[:, i] & (later > i)
            keep = torch.where(keep[:, i:i + 1], keep & ~row, keep)
        return keep
    for i in range(k):
        row = (_corner_iou(boxes[:, i:i + 1], boxes, off)[:, 0] > thresh) & \
            (later > i)
        if not force_suppress:
            row = row & (ids == ids[:, i:i + 1])
        keep = torch.where(keep[:, i:i + 1], keep & ~row, keep)
    return keep


def _nms_launch(boxes, scores, ids, thresh, force_suppress, off):
    """The keep mask by the CUDA kernel (two launches: the suppression
    bitmask, then the scan), on the caller's stream."""
    b, k = scores.shape
    if b == 0 or k == 0:
        return torch.zeros((b, k), dtype=torch.bool, device=scores.device)
    code = _NMS_DTYPES.get(boxes.dtype)
    if code is None:
        raise MXNetError(f"greedy NMS on CUDA takes float32, float16, "
                         f"bfloat16 or float64 boxes (got {boxes.dtype})")
    boxes = boxes.contiguous()
    if scores.dtype != boxes.dtype:  # read only as score > 0
        scores = (scores > 0).to(boxes.dtype)
    scores = scores.contiguous()
    # ids are only compared for equality: float32 holds every float16,
    # bfloat16 and float32 id exactly, float64 the rest
    ids_f64 = False
    if force_suppress:
        ids = None
    else:
        ids_f64 = ids.dtype not in (torch.float32, torch.float16,
                                    torch.bfloat16)
        ids = ids.to(torch.float64 if ids_f64 else torch.float32).contiguous()
    words = -(-k // 64)
    mask = torch.empty((b, k, words), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    lib = _kernels.load()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        rc = lib.mx_nms_keep(boxes.data_ptr(), scores.data_ptr(),
                             None if ids is None else ids.data_ptr(),
                             mask.data_ptr(), keep.data_ptr(), b, k, code,
                             int(ids_f64), float(thresh), float(off),
                             int(force_suppress), stream)
        if rc == 0:
            _kernels.count_launch(_NMS_NAME)
    if rc != 0:
        raise MXNetError(f"greedy NMS: CUDA launch failed: "
                         f"{_kernels.error_string(rc)} (code {rc})")
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


# ---------------------------------------------------------------------------
# the R-CNN family and the vision ops (the rest of the JAX op file)
# ---------------------------------------------------------------------------

# elements of one chunk's widest intermediate in the ROI ops: rois are
# taken in chunks so that memory stays bounded at R-CNN's shapes
_ROI_CHUNK_ELEMS = 1 << 27


def _divc(a, v):
    """a / v, v a Python number, by a 0-d tensor of a's type and device
    (the card divides by a Python scalar as a product with its
    reciprocal, by a tensor exactly)."""
    return a / torch.full((), float(v), dtype=a.dtype, device=a.device)


def _roi_chunks(r, per_roi):
    step = max(1, _ROI_CHUNK_ELEMS // max(1, per_roi))
    return [(i, min(r, i + step)) for i in range(0, r, step)]


def _bins(lo, extent, n):
    """Integer bin bounds (R, n): floor(lo + p·extent / n) and
    ceil(lo + (p + 1)·extent / n) for p < n, the JAX op's order."""
    p = torch.arange(n, dtype=lo.dtype, device=lo.device)
    start = torch.floor(lo[:, None] + _divc(p * extent[:, None], n))
    end = torch.ceil(lo[:, None] + _divc((p + 1) * extent[:, None], n))
    return start, end


def _bin_windows(start, end, size):
    """The bins clipped to [0, size) as gather indices (R, n, L) and a
    mask of the positions inside each bin; L is the widest bin (read to
    the host: these ops run eagerly)."""
    s = start.clamp(0, size).long()
    e = end.clamp(0, size).long()
    width = int((e - s).max().clamp_min(1)) if s.numel() else 1
    off = torch.arange(width, device=s.device)
    idx = s[..., None] + off
    return idx.clamp_max(size - 1), idx < e[..., None]


def _roi_pool_bins(data, rois, pooled_size, spatial_scale, reduce,
                   psroi=None):
    """Shared core of ROIPooling and PSROIPooling: per roi (R, 5), bins
    from ``_bins``, each reduced over its positions of data (B, C, H, W)
    by ``reduce(values (R, ph, pw, C, Lh, Lw), inside mask)``.  ``psroi``
    is (od, k): bin (py, px) of output channel c reads map (c, py, px)."""
    ph, pw = pooled_size
    b, c, h, w = data.shape
    r = rois.shape[0]
    c_out = psroi[0] if psroi else c
    if data.device.type == "meta":
        return torch.empty((r, c_out, ph, pw), dtype=data.dtype,
                           device="meta")
    bi = rois[:, 0].to(torch.int32).long()
    if psroi is None:
        x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale)
                          for i in range(1, 5))
        rh = (y2 - y1 + 1.0).clamp_min(1.0)
        rw = (x2 - x1 + 1.0).clamp_min(1.0)
    else:
        x1 = torch.round(rois[:, 1]) * spatial_scale
        y1 = torch.round(rois[:, 2]) * spatial_scale
        x2 = torch.round(rois[:, 3] + 1.0) * spatial_scale
        y2 = torch.round(rois[:, 4] + 1.0) * spatial_scale
        rh = (y2 - y1).clamp_min(0.1)
        rw = (x2 - x1).clamp_min(0.1)
    hs, he = _bins(y1, rh, ph)
    ws, we = _bins(x1, rw, pw)
    hidx, hin = _bin_windows(hs, he, h)      # (R, ph, Lh)
    widx, win = _bin_windows(ws, we, w)      # (R, pw, Lw)
    lh, lw = hidx.shape[-1], widx.shape[-1]
    if psroi is None:
        ch = torch.arange(c, device=data.device)[None, None, None, :]
    else:
        od, k = psroi
        ch = (torch.arange(od, device=data.device)[None, None, :] * (k * k)
              + torch.arange(k, device=data.device)[:, None, None] * k
              + torch.arange(k, device=data.device)[None, :, None])[None]
    outs = []
    for lo, hi in _roi_chunks(r, ph * pw * c_out * lh * lw):
        sel = (bi[lo:hi, None, None, None, None, None], ch[..., None, None],
               hidx[lo:hi, :, None, None, :, None],
               widx[lo:hi, None, :, None, None, :])
        vals = data[sel]                       # (r, ph, pw, C, Lh, Lw)
        inside = (hin[lo:hi, :, None, None, :, None]
                  & win[lo:hi, None, :, None, None, :])
        outs.append(reduce(vals, inside))
    return torch.cat(outs).permute(0, 3, 1, 2)


def _max_reduce(vals, inside):
    val = torch.where(inside, vals, float("-inf")).amax(dim=(-2, -1))
    empty = ~inside.any(dim=-1).any(dim=-1)
    return torch.where(empty, 0.0, val)


def _mean_reduce(vals, inside):
    s = torch.where(inside, vals, 0.0).sum(dim=(-2, -1))
    cnt = inside.sum(dim=(-2, -1)).clamp_min(1).to(vals.dtype)
    return s / cnt


def roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """Max-pool each roi (R, 5) [batch_idx, x1, y1, x2, y2] of data (B,
    C, H, W) into pooled_size bins -> (R, C, ph, pw).  Corners are
    rounded half to even, as ``jnp.round`` (the reference rounds half
    away from zero); an empty bin gives 0; the gradient of a bin goes to
    its maximum, split evenly between tied maxima, as the JAX op's."""
    return _roi_pool_bins(data, rois, tuple(pooled_size),
                          _f32(spatial_scale), _max_reduce)


def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=0,
                  pooled_size=7, group_size=0):
    """Position-sensitive ROI pooling (R-FCN): data (B, od·k², H, W);
    bin (py, px) of output channel c averages map (c, py, px) over the
    bin -> (R, od, k, k)."""
    k = int(pooled_size)
    g = int(group_size) if group_size else k
    if g != k:
        raise MXNetError("PSROIPooling: group_size != pooled_size is not "
                         "supported (the standard R-FCN configuration)")
    od = int(output_dim)
    if od * k * k != data.shape[1]:
        raise MXNetError(
            f"PSROIPooling: data needs output_dim*pooled_size^2 = "
            f"{od}*{k}*{k} = {od * k * k} channels (got {data.shape[1]})")
    return _roi_pool_bins(data, rois, (k, k), _f32(spatial_scale),
                          _mean_reduce, psroi=(od, k))


def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=2, position_sensitive=False, aligned=False):
    """Bilinear ROI align: each bin the mean of sample_ratio² bilinear
    samples, coordinates clipped into the map (the JAX op's convention).
    ``position_sensitive``: data has C_out·ph·pw channels and bin (py,
    px) of output channel c reads channel c·ph·pw + py·pw + px;
    ``aligned`` shifts by half a pixel."""
    ph, pw = tuple(pooled_size)
    sr = max(int(sample_ratio), 1)
    b, c, h, w = data.shape
    if position_sensitive and c % (ph * pw) != 0:
        raise MXNetError(
            f"position_sensitive ROIAlign needs channels divisible by "
            f"pooled_h*pooled_w; got C={c}, pooled={ph}x{pw}")
    c_out = c // (ph * pw) if position_sensitive else c
    r = rois.shape[0]
    if data.device.type == "meta":
        return torch.empty((r, c_out, ph, pw), dtype=data.dtype,
                           device="meta")
    dev = data.device
    off = 0.5 if aligned else 0.0
    scale = _f32(spatial_scale)
    bi = rois[:, 0].to(torch.int32).long()
    x1, y1, x2, y2 = (rois[:, i] * scale - off for i in range(1, 5))
    floor = 1e-6 if aligned else 1.0
    bh = _divc((y2 - y1).clamp_min(floor), ph)
    bw = _divc((x2 - x1).clamp_min(floor), pw)
    samp = torch.arange(sr, dtype=rois.dtype, device=dev) + 0.5

    def coords(lo, step, n, size):
        p = torch.arange(n, dtype=rois.dtype, device=dev)
        v = (lo[:, None, None] + (p * step[:, None])[:, :, None]
             + _divc(samp * step[:, None, None], sr))   # (R, n, sr)
        v = v.clamp(0.0, size - 1.0)
        v0 = torch.floor(v)
        i0 = v0.long()
        return i0, (i0 + 1).clamp_max(size - 1), v - v0

    y0i, y1i, ly = coords(y1, bh, ph, h)
    x0i, x1i, lx = coords(x1, bw, pw, w)
    if position_sensitive:
        ch = (torch.arange(c_out, device=dev) * (ph * pw))[None, None, :] \
            + (torch.arange(ph, device=dev)[:, None, None] * pw
               + torch.arange(pw, device=dev)[None, :, None])
        ch = ch[None, :, None, :, None, :]     # (1, ph, 1, pw, 1, C)
    else:
        ch = torch.arange(c, device=dev)[None, None, None, None, None, :]
    outs = []
    for lo, hi in _roi_chunks(r, 4 * ph * pw * sr * sr * c_out):
        bsel = bi[lo:hi, None, None, None, None, None]
        ya, yb = (t[lo:hi, :, :, None, None, None] for t in (y0i, y1i))
        xa, xb = (t[lo:hi, None, None, :, :, None] for t in (x0i, x1i))
        wy = ly[lo:hi, :, :, None, None, None]
        wx = lx[lo:hi, None, None, :, :, None]
        v = (data[bsel, ch, ya, xa] * (1 - wy) * (1 - wx)
             + data[bsel, ch, ya, xb] * (1 - wy) * wx
             + data[bsel, ch, yb, xa] * wy * (1 - wx)
             + data[bsel, ch, yb, xb] * wy * wx)   # (r, ph, sr, pw, sr, C)
        outs.append(v.mean(dim=(2, 4)))
    return torch.cat(outs).permute(0, 3, 1, 2)


def boolean_mask(data, index, axis=0):
    """The entries of data along ``axis`` where index != 0.  The output's
    shape depends on the data, so this op reads the mask to the host: it
    runs eagerly only, and raises inside a CUDA graph capture (the JAX
    op is ``no_jit`` for the same reason)."""
    if data.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise MXNetError("boolean_mask: the output's shape depends on the "
                         "mask, so it cannot run inside a captured graph; "
                         "use where/multiplication masking there")
    keep = torch.nonzero(index != 0)[:, 0].to(data.device)
    return torch.index_select(data, int(axis), keep)


def fft(data, compute_size=128):
    """1-d FFT over the last axis: real (..., d) -> interleaved re/im
    (..., 2d), float32 (the reference's cuFFT convention)."""
    spec = torch.fft.fft(data.to(torch.complex64), dim=-1)
    out = torch.stack([spec.real, spec.imag], dim=-1)
    return out.reshape(*data.shape[:-1], 2 * data.shape[-1]).to(
        torch.float32)


def ifft(data, compute_size=128):
    """Inverse of :func:`fft`: interleaved (..., 2d) -> real (..., d),
    unnormalised (scaled by d; callers divide, as with cuFFT)."""
    d = data.shape[-1] // 2
    pairs = data.reshape(*data.shape[:-1], d, 2)
    spec = torch.complex(pairs[..., 0].float(), pairs[..., 1].float())
    return (torch.fft.ifft(spec, dim=-1).real * d).to(torch.float32)


def _proposal_anchors(h, w, scales, ratios, feature_stride, dev):
    """(H·W·A, 4) anchors: the reference's GenerateAnchors base boxes
    (integer-rounded ratio sides, the (bs - 1) / 2 centre) in Python
    floats, shifted by the stride over the map."""
    bs = float(feature_stride)
    ctr = (bs - 1.0) / 2.0
    base = []
    for r in ratios:
        ws0 = round(math.sqrt(bs * bs / r))
        hs0 = round(ws0 * r)
        for s in scales:
            bw, bh = ws0 * s, hs0 * s
            base.append((ctr - (bw - 1) / 2.0, ctr - (bh - 1) / 2.0,
                         ctr + (bw - 1) / 2.0, ctr + (bh - 1) / 2.0))
    base = torch.from_numpy(np.asarray(base, np.float32)).to(dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev) * _f32(bs)
    ys = torch.arange(h, dtype=torch.float32, device=dev) * _f32(bs)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    shifts = torch.stack([gx, gy, gx, gy], -1)
    return (shifts[:, :, None, :] + base[None, None]).reshape(-1, 4)


def proposal_candidates(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                        rpn_min_size=16, scales=(4, 8, 16, 32),
                        ratios=(0.5, 1, 2), feature_stride=16):
    """Proposal's NMS candidates: the decoded, clipped boxes (B, k, 4)
    and scores (B, k) of the pre-NMS top k, in score order (-inf where
    a box is under the minimum size)."""
    cls_prob, bbox_pred = cls_prob.detach(), bbox_pred.detach()
    b, a2, h, w = cls_prob.shape
    a = a2 // 2
    scales, ratios = tuple(scales), tuple(ratios)
    if a != len(scales) * len(ratios):
        raise MXNetError(
            f"Proposal: cls_prob has {a} anchors per cell but "
            f"scales x ratios = {len(scales)} x {len(ratios)} = "
            f"{len(scales) * len(ratios)}")
    dev = cls_prob.device
    anchors = _proposal_anchors(h, w, scales, ratios, feature_stride, dev)
    scores = cls_prob[:, a:].reshape(b, a, h, w).permute(0, 2, 3, 1) \
        .reshape(b, -1)
    dl = bbox_pred.reshape(b, a, 4, h, w).permute(0, 3, 4, 1, 2) \
        .reshape(b, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    ax = anchors[:, 0] + 0.5 * (aw - 1.0)
    ay = anchors[:, 1] + 0.5 * (ah - 1.0)
    cx = dl[..., 0] * aw + ax
    cy = dl[..., 1] * ah + ay
    bw = torch.exp(dl[..., 2]) * aw
    bh = torch.exp(dl[..., 3]) * ah
    boxes = torch.stack([cx - 0.5 * (bw - 1.0), cy - 0.5 * (bh - 1.0),
                         cx + 0.5 * (bw - 1.0), cy + 0.5 * (bh - 1.0)], -1)
    info = im_info.detach().to(torch.float32)
    lim = torch.stack([info[:, 1], info[:, 0], info[:, 1], info[:, 0]],
                      -1) - 1.0
    boxes = torch.minimum(boxes.clamp_min(0.0), lim[:, None, :])
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    min_size = info[:, 2:3] * _f32(rpn_min_size)
    ok = (ws >= min_size) & (hs >= min_size)
    scores = torch.where(ok, scores, float("-inf"))
    k = min(int(rpn_pre_nms_top_n), scores.shape[1])
    top_sc, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    return _gather_rows(boxes, top_i[:, :k]), top_sc[:, :k]


def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """RPN proposals (Proposal and MultiProposal): anchors and predicted
    deltas decoded with the legacy +1 width, clipped to the image,
    filtered at rpn_min_size · im_info[2], the pre-NMS top
    rpn_pre_nms_top_n by score (a stable sort: among ties the lower
    index first, as ``lax.top_k``), NMS at ``threshold`` with the +1
    IoU, kept rows first (a stable sort), cut or zero-padded to
    rpn_post_nms_top_n.  rois (B·post, 5) [batch_idx, x1, y1, x2, y2],
    suppressed rows zero; with output_score also the scores (B·post,
    1)."""
    if iou_loss:
        raise MXNetError("Proposal: iou_loss=True (direct corner-offset "
                         "decoding) is not implemented in this build")
    top_boxes, top_sc = proposal_candidates(
        cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n, rpn_min_size,
        scales, ratios, feature_stride)
    b, dev = cls_prob.shape[0], cls_prob.device
    keep = greedy_nms_keep(top_boxes, top_sc, None, _f32(threshold), True,
                           off=1.0)
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    post = int(rpn_post_nms_top_n)
    kept_boxes = _gather_rows(top_boxes, order)[:, :post]
    kept_sc = torch.gather(torch.where(keep, top_sc, 0.0), 1, order)[:, :post]
    pad = post - kept_boxes.shape[1]
    if pad > 0:
        kept_boxes = torch.nn.functional.pad(kept_boxes, (0, 0, 0, pad))
        kept_sc = torch.nn.functional.pad(kept_sc, (0, pad))
    valid = (kept_sc > 0).to(torch.float32)[..., None]
    kept_boxes = kept_boxes * valid
    batch_idx = torch.arange(b, dtype=kept_boxes.dtype, device=dev) \
        .repeat_interleave(post)[:, None]
    rois = torch.cat([batch_idx, kept_boxes.reshape(-1, 4)], 1)
    if output_score:
        return rois, kept_sc.reshape(-1, 1)
    return rois


def _resize_axis_align_corners(x, axis, out_size):
    """Align-corners bilinear along one axis: output i samples input
    i·(in - 1)/(out - 1) (the reference's bilinear_resize.cc mapping)."""
    in_size = x.shape[axis]
    if out_size == in_size:
        return x
    dev = x.device
    if in_size == 1 or out_size == 1:
        coords = torch.zeros(out_size, dtype=torch.float32, device=dev)
    else:
        coords = torch.arange(out_size, dtype=torch.float32, device=dev) \
            * _f32((in_size - 1) / (out_size - 1))
    i0 = torch.floor(coords).to(torch.int32).clamp(0, in_size - 1)
    i1 = (i0 + 1).clamp(0, in_size - 1)
    frac = (coords - i0).to(x.dtype)
    shape = [1] * x.dim()
    shape[axis] = out_size
    frac = frac.reshape(shape)
    lo = torch.index_select(x, axis, i0.long())
    hi = torch.index_select(x, axis, i1.long())
    return lo * (1 - frac) + hi * frac


def bilinear_resize2d(data, like=None, height=0, width=0, scale_height=None,
                      scale_width=None, mode="size"):
    """Bilinear resize of NCHW with align-corners sampling; the target
    size from ``like`` (mode "like"), the scales, or height/width."""
    if mode not in ("size", "like"):
        raise MXNetError(
            f"BilinearResize2D: mode {mode!r} is not implemented "
            "(supported: 'size', 'like'; the odd_scale/to_even_* "
            "size policies of the reference are not)")
    n, c, h, w = data.shape
    if like is not None and mode == "like":
        th, tw = like.shape[2], like.shape[3]
    elif scale_height is not None and scale_width is not None:
        th, tw = int(h * scale_height), int(w * scale_width)
    else:
        th, tw = int(height), int(width)
    if th <= 0 or tw <= 0:
        raise MXNetError("BilinearResize2D: target size must be positive "
                         f"(got {(th, tw)})")
    out = _resize_axis_align_corners(data, 2, th)
    return _resize_axis_align_corners(out, 3, tw)


def adaptive_avg_pooling2d(data, output_size=()):
    """Adaptive average pooling of NCHW to output_size: the mean of equal
    windows where the size divides, else an integral image's exact
    windows floor(i·H/th) .. ceil((i + 1)·H/th)."""
    n, c, h, w = data.shape
    if not output_size:
        th = tw = 1
    elif isinstance(output_size, int):
        th = tw = int(output_size)
    elif len(output_size) == 1:
        th = tw = int(output_size[0])
    else:
        th, tw = int(output_size[0]), int(output_size[1])
    if h % th == 0 and w % tw == 0:
        return data.reshape(n, c, th, h // th, tw, w // tw).mean((3, 5))
    csum = torch.nn.functional.pad(data.cumsum(2).cumsum(3), (1, 0, 1, 0))
    dev = data.device
    ar_h, ar_w = torch.arange(th, device=dev), torch.arange(tw, device=dev)
    y0, y1 = (ar_h * h) // th, -(-((ar_h + 1) * h) // th)
    x0, x1 = (ar_w * w) // tw, -(-((ar_w + 1) * w) // tw)
    area = ((y1 - y0)[:, None] * (x1 - x0)[None, :]).to(data.dtype)
    s = (csum[:, :, y1][:, :, :, x1] - csum[:, :, y0][:, :, :, x1]
         - csum[:, :, y1][:, :, :, x0] + csum[:, :, y0][:, :, :, x0])
    return s / area


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
register_op("ROIPooling", aliases=("roi_pooling", "_contrib_ROIPooling"))(
    roi_pooling)
register_op("ROIAlign", aliases=("_contrib_ROIAlign",))(roi_align)
register_op("boolean_mask", aliases=("_contrib_boolean_mask",),
            differentiable=False)(boolean_mask)
register_op("_contrib_fft", aliases=("fft",))(fft)
register_op("_contrib_ifft", aliases=("ifft",))(ifft)
register_op("_contrib_Proposal", aliases=(
    "Proposal", "_contrib_MultiProposal", "MultiProposal"),
    differentiable=False,
    num_outputs=lambda attrs: 2 if attrs.get("output_score") else 1)(
    proposal)
register_op("_contrib_BilinearResize2D", aliases=("BilinearResize2D",))(
    bilinear_resize2d)
register_op("_contrib_AdaptiveAvgPooling2D",
            aliases=("AdaptiveAvgPooling2D",))(adaptive_avg_pooling2d)
register_op("_contrib_PSROIPooling", aliases=("PSROIPooling",))(
    psroi_pooling)


def __getattr__(name: str):
    """``F.contrib.foreach``/``while_loop``/``cond`` in a
    ``hybrid_forward``: the control flow of ``contrib/control_flow.py``
    on tensors (imported on first use)."""
    if name in ("foreach", "while_loop", "cond"):
        from ..contrib import control_flow

        return getattr(control_flow, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
