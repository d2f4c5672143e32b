"""COCO-style AP without pycocotools: the port's copy of
`dcfa_yolo_tpu/evalmap/coco_map.py` (numpy only).

The reference's `get_coco_map` (`utils/utils_map.py:1032-1132`) converts the
same ground-truth/detection-results text files to COCO json and runs COCOeval;
here the COCOeval protocol itself is implemented natively:

  * IoU thresholds 0.5:0.05:0.95, 101-point interpolated precision
    (COCOeval.accumulate);
  * greedy matching per (image, class) in score order, each non-ignored gt
    used once per threshold; equal-IoU ties go to the LATER gt in iteration
    order (pycocotools `ious[dind,gind] < iou: continue` uses >= to update);
  * `difficult` gt boxes become `iscrowd=1` annotations — this is EXACTLY what
    the reference's converter does (`utils/utils_map.py:835,878`:
    `annotation['iscrowd'] = difficult`), so COCOeval treats them as IGNORE
    regions: their IoU is intersection-over-DETECTION-area, they can absorb
    any number of detections, matched detections count as neither TP nor FP,
    and they are excluded from the recall denominator;
  * a detection only falls through to an ignored gt if NO normal gt matched
    (COCOeval's `m>-1 and gtIg[m]==0 and gtIg[gind]==1: break` with gts
    sorted normal-first);
  * maxDets=100 cap per image per class (COCO default), applied in score
    order; score ties resolve by stable sort = annotation/file order, the
    same as pycocotools' kind='mergesort'.

Pinned by adversarial vectors in tests/test_coco_adversarial.py (score ties,
difficult/crowd matching, maxDets edge, multi-class NaN averaging).

Returns [AP@0.5:0.95, AP@0.5], matching the reference's use of
`get_coco_map(...)[1]` as AP50.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from dcfa_yolo_tpu_torch.evalmap.voc_map import _parse_dr_dir, _parse_gt_dir

# linspace, not arange: arange(0.5, 1.0, 0.05) drifts (last value
# 0.9500000000000004), which would flip IoU==0.95 matches vs COCOeval
IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _iou_xyxy(bb: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(nd, ng) IoU matrix, COCO convention (no +1).

    For iscrowd gts the denominator is the DETECTION area alone
    (pycocotools `maskUtils.iou`'s crowd semantics): a detection inside a
    large ignore region scores IoU 1 against it.
    """
    if len(bb) == 0 or len(gt) == 0:
        return np.zeros((len(bb), len(gt)))
    ixmin = np.maximum(bb[:, None, 0], gt[None, :, 0])
    iymin = np.maximum(bb[:, None, 1], gt[None, :, 1])
    ixmax = np.minimum(bb[:, None, 2], gt[None, :, 2])
    iymax = np.minimum(bb[:, None, 3], gt[None, :, 3])
    iw = np.clip(ixmax - ixmin, 0, None)
    ih = np.clip(iymax - iymin, 0, None)
    inter = iw * ih
    area_d = (bb[:, 2] - bb[:, 0]) * (bb[:, 3] - bb[:, 1])
    area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :].astype(bool), area_d[:, None], union)
    return inter / np.maximum(union, 1e-12)


def _class_ap(dets: List[dict], gt_by_image: Dict[str, Tuple[np.ndarray, np.ndarray]],
              n_gt: int, max_dets: int = 100) -> np.ndarray:
    """AP at each IoU threshold for one class.

    dets: score-sorted (stable) across images; gt_by_image maps file_id →
    (boxes (G,4), ignore flags (G,)).  n_gt counts NON-ignored gts only.
    """
    if n_gt == 0:
        return np.full(len(IOU_THRESHOLDS), np.nan)
    per_image_count: Dict[str, int] = defaultdict(int)
    kept = []
    for d in dets:
        if per_image_count[d["file_id"]] < max_dets:
            per_image_count[d["file_id"]] += 1
            kept.append(d)
    nd = len(kept)
    if nd == 0:
        # gt exists but nothing was detected: AP 0 at every threshold (the
        # size-0 precision array would otherwise crash the interpolation)
        return np.zeros(len(IOU_THRESHOLDS))
    tp = np.zeros((len(IOU_THRESHOLDS), nd))
    dt_ignore = np.zeros((len(IOU_THRESHOLDS), nd), bool)
    used: Dict[Tuple[int, str], np.ndarray] = {}
    ious_cache: Dict[str, np.ndarray] = {}
    order_cache: Dict[str, np.ndarray] = {}
    det_idx_in_image: Dict[str, int] = defaultdict(int)

    for di, d in enumerate(kept):
        fid = d["file_id"]
        boxes_g, ign_g = gt_by_image.get(
            fid, (np.zeros((0, 4)), np.zeros((0,), bool)))
        if fid not in ious_cache:
            boxes_d = np.array([dd["bbox"] for dd in kept if dd["file_id"] == fid])
            ious_cache[fid] = _iou_xyxy(boxes_d, boxes_g, ign_g)
            # COCOeval iterates gts non-ignored first (stable)
            order_cache[fid] = np.argsort(ign_g, kind="stable")
        row = ious_cache[fid][det_idx_in_image[fid]]
        det_idx_in_image[fid] += 1
        gt_order = order_cache[fid]
        for ti, thr in enumerate(IOU_THRESHOLDS):
            key = (ti, fid)
            if key not in used:
                used[key] = np.zeros(len(boxes_g), bool)
            best, best_j = min(thr, 1 - 1e-10), -1
            for j in gt_order:
                # a matched NON-ignored gt is consumed; ignored gts absorb
                # any number of detections (COCOeval's crowd behavior)
                if used[key][j] and not ign_g[j]:
                    continue
                # once iterating into the ignored tail with a normal match in
                # hand, stop — never trade a normal match for an ignore match
                if best_j > -1 and not ign_g[best_j] and ign_g[j]:
                    break
                if row[j] >= best:
                    best, best_j = row[j], j
            if best_j >= 0:
                used[key][best_j] = True
                if ign_g[best_j]:
                    dt_ignore[ti, di] = True  # neither TP nor FP
                else:
                    tp[ti, di] = 1

    aps = np.zeros(len(IOU_THRESHOLDS))
    for ti in range(len(IOU_THRESHOLDS)):
        live = ~dt_ignore[ti]
        # ignored detections contribute to neither cumsum (COCOeval masks
        # them out of tps/fps before accumulating)
        tp_cum = np.cumsum(tp[ti] * live)
        fp_cum = np.cumsum((1 - tp[ti]) * live)
        rec = tp_cum / n_gt
        prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        # 101-point interpolation with monotone precision (COCOeval accumulate)
        for i in range(len(prec) - 1, 0, -1):
            prec[i - 1] = max(prec[i - 1], prec[i])
        idx = np.searchsorted(rec, RECALL_POINTS, side="left")
        q = np.where(idx < len(prec), prec[np.minimum(idx, max(len(prec) - 1, 0))], 0.0)
        aps[ti] = q.mean() if len(prec) else 0.0
    return aps


def get_coco_map(class_names: Sequence[str], path: str = "map_out",
                 max_dets: int = 100) -> List[float]:
    """→ [AP@0.5:0.95, AP@0.5] over the text-file protocol."""
    per_image_gt, gt_counter, _ = _parse_gt_dir(os.path.join(path, "ground-truth"))
    per_class_dr, _ = _parse_dr_dir(os.path.join(path, "detection-results"),
                                    list(class_names))

    all_aps = []
    for cname in class_names:
        gt_by_image = {}
        n_gt = 0
        for fid, objs in per_image_gt.items():
            objs_c = [o for o in objs if o["class_name"] == cname]
            boxes = np.array([o["bbox"] for o in objs_c]).reshape(-1, 4)
            ign = np.array([o["difficult"] for o in objs_c], bool).reshape(-1)
            gt_by_image[fid] = (boxes, ign)
            n_gt += int((~ign).sum())
        aps = _class_ap(per_class_dr.get(cname, []), gt_by_image, n_gt, max_dets)
        all_aps.append(aps)
    ap_matrix = np.array(all_aps)  # (n_classes, n_thresholds)
    with np.errstate(invalid="ignore"):
        mean_per_thr = np.nanmean(ap_matrix, axis=0)
    if np.all(np.isnan(mean_per_thr)):
        return [0.0, 0.0]
    return [float(np.nanmean(mean_per_thr)), float(mean_per_thr[0])]
