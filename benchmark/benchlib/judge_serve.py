"""Judging served detections against the reference's per-anchor
predictions.

A served answer is one image's detections: boxes in original-image pixels
[y1, x1, y2, x2], scores and classes, after the fixed-shape greedy NMS.
The reference gives every anchor's box, score and class in float32.
Greedy NMS is discontinuous (a score that moves by a rounding can change
which box survives), so the detections are not compared with the
reference's own NMS.  They are held to what makes a set of detections the
greedy result of those predictions:

- `det_gap`: every detection is some anchor's prediction.  For each
  detection, the least over the anchors of its class of
  max(|score − q|, |box − r|∞ / S), S the image's longer side; the number
  is the largest over the detections.
- `nms_miss`: every candidate is kept or suppressed.  A candidate is an
  anchor whose reference score clears the score floor by `tol` (the
  confidence threshold, the pre-NMS top-k's last score, and, when the
  answer holds max_det detections, its lowest score).  It is kept when a
  detection lies within `tol` of it, suppressed when a detection of its
  class with a score at least its own less `tol` overlaps it by more than
  the IoU threshold, its box given `tol`·S pixels either way.  The number
  counts the candidates that are neither.  `tol` is the cell's `nms_tol`,
  the slack bfloat16 rounding needs.
- `nms_overlap`: no two detections of a class overlap by more than the
  threshold (plus 1e-3 for the rounding of the unmap): the number of
  pairs that do.
"""

from __future__ import annotations

from typing import Dict

import torch


def _area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]).clamp_min(0) * (b[..., 3] - b[..., 1]).clamp_min(0)


def _inter(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) intersection areas of [y1, x1, y2, x2] boxes."""
    lo = torch.maximum(a[:, None, :2], b[None, :, :2])
    hi = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    return (hi - lo).clamp_min(0).prod(-1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    inter = _inter(a, b)
    return inter / (_area(a)[:, None] + _area(b)[None, :] - inter + 1e-7)


def iou_upper(a: torch.Tensor, b: torch.Tensor, e: float) -> torch.Tensor:
    """(N, M) upper bound of IoU(a, b') over every b' within e pixels of b
    in each coordinate."""
    grow = torch.cat([b[:, :2] - e, b[:, 2:] + e], 1)
    shrink = torch.cat([b[:, :2] + e, b[:, 2:] - e], 1)
    inter = _inter(a, grow)
    ab, bb = _area(a)[:, None], _area(shrink)[None, :]
    union = torch.maximum(torch.maximum(ab + bb - inter, ab), bb)
    return inter / union.clamp_min(1e-7)


def judge_image(det_boxes, det_scores, det_classes, ref_boxes, ref_scores,
                ref_classes, *, image_hw, conf: float, iou_thres: float,
                topk: int, max_det: int, tol: float) -> Dict[str, float]:
    """The three numbers for one image (module docstring).  Detections:
    (n, 4), (n,), (n,); reference: (A, 4), (A,), (A,), all on one device."""
    dev = ref_boxes.device
    db = torch.as_tensor(det_boxes, dtype=torch.float32, device=dev).reshape(-1, 4)
    ds = torch.as_tensor(det_scores, dtype=torch.float32, device=dev).reshape(-1)
    dc = torch.as_tensor(det_classes, device=dev).reshape(-1).long()
    rb, rs, rc = ref_boxes.float(), ref_scores.float(), ref_classes.long()
    side = float(max(image_hw))
    n = len(ds)
    out = dict(det_gap=0.0, nms_miss=0.0, nms_overlap=0.0)
    if n:
        same = dc[:, None] == rc[None, :]
        d = torch.maximum((ds[:, None] - rs[None, :]).abs(),
                          (db[:, None, :] - rb[None, :, :]).abs().amax(-1) / side)
        d = torch.where(same, d, torch.inf)
        out["det_gap"] = float(d.amin(1).max())
        ov = iou(db, db)
        pair = (dc[:, None] == dc[None, :]) & torch.ones_like(ov, dtype=torch.bool).triu(1)
        out["nms_overlap"] = float(((ov > iou_thres + 1e-3) & pair).sum())
    floor = conf
    ranked = torch.sort(rs[rs >= conf], descending=True).values
    if len(ranked) > topk:
        floor = max(floor, float(ranked[topk - 1]))
    if n >= max_det:
        floor = max(floor, float(ds.min()))
    cand = torch.nonzero(rs >= floor + tol)[:, 0]
    if len(cand) == 0:
        return out
    if n == 0:
        out["nms_miss"] = float(len(cand))
        return out
    cb, cs, cc = rb[cand], rs[cand], rc[cand]
    same = dc[:, None] == cc[None, :]
    d = torch.maximum((ds[:, None] - cs[None, :]).abs(),
                      (db[:, None, :] - cb[None, :, :]).abs().amax(-1) / side)
    kept = ((d <= tol) & same).any(0)
    sup = ((iou_upper(db, cb, tol * side) > iou_thres) & same
           & (ds[:, None] >= cs[None, :] - tol)).any(0)
    out["nms_miss"] = float((~(kept | sup)).sum())
    return out


def combine(readings) -> Dict[str, float]:
    """The worst of each number over the judged images (sums for counts)."""
    total = dict(det_gap=0.0, nms_miss=0.0, nms_overlap=0.0)
    for r in readings:
        total["det_gap"] = max(total["det_gap"], r["det_gap"])
        total["nms_miss"] += r["nms_miss"]
        total["nms_overlap"] += r["nms_overlap"]
    return total
