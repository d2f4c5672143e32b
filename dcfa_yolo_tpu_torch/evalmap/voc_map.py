"""VOC-style mAP over the text-file protocol of `utils/utils_map.py:309-811`:
the port's copy of `dcfa_yolo_tpu/evalmap/voc_map.py` (numpy only).

Same on-disk contract as the reference:
    {path}/ground-truth/{id}.txt    lines: `cls x1 y1 x2 y2 [difficult]`
    {path}/detection-results/{id}.txt  lines: `cls conf x1 y1 x2 y2`
and the same matching conventions:
    * IoU with the +1-pixel convention (`utils/utils_map.py:502-506`);
    * detections sorted by confidence descending; each gt matched once
      ("used" flag), repeats are FPs; matches to difficult gt are ignored
      (neither TP nor FP);
    * VOC2012 AP: pad (0,rec,1)/(0,prec,0), monotone precision, area at
      recall steps;
    * P/R/F1 reported at the last detection index with score ≥ score_threshold;
    * log-average miss rate over 9 log-spaced FPPI points.

Writes results.txt (+ optional plots) and returns the mAP fraction, like
`get_map` (`utils/utils_map.py:309`).
"""

from __future__ import annotations

import glob
import math
import os
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np


def _parse_gt_dir(gt_path: str) -> Tuple[Dict[str, List[dict]], Dict[str, int], List[str]]:
    """→ (per-image gt objects, gt count per class (non-difficult), class list)."""
    per_image: Dict[str, List[dict]] = {}
    counter: Dict[str, int] = defaultdict(int)
    for txt in sorted(glob.glob(os.path.join(gt_path, "*.txt"))):
        file_id = os.path.splitext(os.path.basename(txt))[0]
        objs = []
        with open(txt) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                difficult = parts[-1] == "difficult"
                if difficult:
                    name = " ".join(parts[:-5])
                    coords = parts[-5:-1]
                else:
                    name = " ".join(parts[:-4])
                    coords = parts[-4:]
                objs.append({
                    "class_name": name,
                    "bbox": [float(c) for c in coords],
                    "difficult": difficult,
                    "used": False,
                })
                if not difficult:
                    counter[name] += 1
        per_image[file_id] = objs
    classes = sorted(counter.keys())
    return per_image, dict(counter), classes


def _parse_dr_dir(dr_path: str, classes: List[str]
                  ) -> Tuple[Dict[str, List[dict]], Dict[str, int]]:
    """→ (per-class detections sorted by confidence descending,
    detection count per class over ALL classes seen in the files —
    `utils/utils_map.py:705-715`)."""
    per_class: Dict[str, List[dict]] = {c: [] for c in classes}
    det_counter: Dict[str, int] = defaultdict(int)
    for txt in sorted(glob.glob(os.path.join(dr_path, "*.txt"))):
        file_id = os.path.splitext(os.path.basename(txt))[0]
        with open(txt) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 6:
                    continue
                name = " ".join(parts[:-5])
                conf = float(parts[-5])
                bbox = [float(c) for c in parts[-4:]]
                det_counter[name] += 1
                if name in per_class:
                    per_class[name].append(
                        {"file_id": file_id, "confidence": conf, "bbox": bbox})
    for c in per_class:
        per_class[c].sort(key=lambda d: d["confidence"], reverse=True)
    return per_class, dict(det_counter)


def _iou_plus_one(bb: List[float], bbgt: List[float]) -> float:
    """VOC devkit IoU with +1-pixel areas (`utils/utils_map.py:502-506`)."""
    ixmin, iymin = max(bb[0], bbgt[0]), max(bb[1], bbgt[1])
    ixmax, iymax = min(bb[2], bbgt[2]), min(bb[3], bbgt[3])
    iw, ih = ixmax - ixmin + 1, iymax - iymin + 1
    if iw <= 0 or ih <= 0:
        return -1.0
    ua = ((bb[2] - bb[0] + 1) * (bb[3] - bb[1] + 1)
          + (bbgt[2] - bbgt[0] + 1) * (bbgt[3] - bbgt[1] + 1) - iw * ih)
    return iw * ih / ua


def voc_ap(rec: List[float], prec: List[float]) -> Tuple[float, List[float], List[float]]:
    """VOC2012 all-points AP (`utils/utils_map.py:107-155`, minus file IO)."""
    mrec = [0.0] + list(rec) + [1.0]
    mpre = [0.0] + list(prec) + [0.0]
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    ap = 0.0
    for i in range(1, len(mrec)):
        if mrec[i] != mrec[i - 1]:
            ap += (mrec[i] - mrec[i - 1]) * mpre[i]
    return ap, mrec, mpre


def log_average_miss_rate(precision: np.ndarray, fp_cumsum: np.ndarray,
                          num_images: int) -> float:
    """(`utils/utils_map.py:34-70`)."""
    if precision.size == 0:
        return 0.0
    fppi = fp_cumsum / float(num_images)
    mr = 1.0 - precision
    fppi_tmp = np.insert(fppi, 0, -1.0)
    mr_tmp = np.insert(mr, 0, 1.0)
    ref = np.logspace(-2.0, 0.0, num=9)
    for i, ref_i in enumerate(ref):
        j = np.where(fppi_tmp <= ref_i)[0][-1]
        ref[i] = mr_tmp[j]
    return math.exp(np.mean(np.log(np.maximum(1e-10, ref))))


def get_map(min_overlap: float = 0.5, draw_plot: bool = False,
            score_threshold: float = 0.5, path: str = "map_out") -> float:
    """Compute mAP@min_overlap from {path}/ground-truth + detection-results.

    Returns the mAP as a fraction in [0, 1] (reference prints percent but
    returns the fraction, `utils/utils_map.py:809-811`).
    """
    gt_path = os.path.join(path, "ground-truth")
    dr_path = os.path.join(path, "detection-results")
    results_path = os.path.join(path, "results")
    os.makedirs(results_path, exist_ok=True)

    per_image_gt, gt_counter, classes = _parse_gt_dir(gt_path)
    per_class_dr, det_counter = _parse_dr_dir(dr_path, classes)
    n_images = len(per_image_gt)

    sum_ap = 0.0
    ap_dict: Dict[str, float] = {}
    lamr_dict: Dict[str, float] = {}
    tp_counter: Dict[str, int] = defaultdict(int)
    lines = ["# AP and precision/recall per class\n"]
    for class_name in classes:
        detections = per_class_dr.get(class_name, [])
        nd = len(detections)
        tp = np.zeros(nd)
        fp = np.zeros(nd)
        scores = np.zeros(nd)
        score_threshold_idx = 0
        for idx, det in enumerate(detections):
            scores[idx] = det["confidence"]
            if det["confidence"] >= score_threshold:
                score_threshold_idx = idx
            gt_objs = per_image_gt.get(det["file_id"], [])
            ovmax, gt_match = -1.0, None
            for obj in gt_objs:
                if obj["class_name"] != class_name:
                    continue
                ov = _iou_plus_one(det["bbox"], obj["bbox"])
                if ov > ovmax:
                    ovmax, gt_match = ov, obj
            if ovmax >= min_overlap and gt_match is not None:
                if not gt_match["difficult"]:
                    if not gt_match["used"]:
                        tp[idx] = 1
                        gt_match["used"] = True
                        tp_counter[class_name] += 1
                    else:
                        fp[idx] = 1
                # matches to difficult gt count as neither TP nor FP
            else:
                fp[idx] = 1

        fp_cum = np.cumsum(fp)
        tp_cum = np.cumsum(tp)
        n_gt = max(gt_counter.get(class_name, 0), 1)
        rec = (tp_cum / n_gt).tolist()
        prec = (tp_cum / np.maximum(tp_cum + fp_cum, 1)).tolist()
        ap, mrec, mpre = voc_ap(rec[:], prec[:])
        sum_ap += ap
        ap_dict[class_name] = ap
        lamr = log_average_miss_rate(np.asarray(prec), fp_cum, n_images)
        lamr_dict[class_name] = lamr

        if nd:
            i = score_threshold_idx
            p, r = prec[i], rec[i]
            f1 = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
        else:
            p = r = f1 = 0.0
        # reference results.txt block (`utils/utils_map.py:613-628`): AP line
        # + rounded precision/recall arrays; the F1/R/P@threshold summary the
        # reference only prints is also recorded here for grepability
        lines.append(f"{ap * 100:.2f}% = {class_name} AP "
                     f"|| score_threhold={score_threshold} : "
                     f"F1={f1:.2f} ; Recall={r * 100:.2f}% ; "
                     f"Precision={p * 100:.2f}% ; lamr={lamr:.2f}\n")
        lines.append(" Precision: " + str(["%.2f" % e for e in prec]) + "\n")
        lines.append(" Recall :" + str(["%.2f" % e for e in rec]) + "\n\n")

        if draw_plot:
            f1_curve = (2 * np.asarray(rec) * np.asarray(prec)
                        / np.maximum(np.asarray(rec) + np.asarray(prec), 1e-12))
            _plot_pr(mrec, mpre, ap, class_name, results_path)
            # reference score-threshold curves (`utils/utils_map.py:662-688`)
            for sub, ys, label in (("F1", f1_curve, "F1"),
                                   ("Recall", rec, "Recall"),
                                   ("Precision", prec, "Precision")):
                _plot_curve(scores, ys, class_name, sub, label, results_path,
                            score_threshold)

    n_classes = max(len(classes), 1)
    mAP = sum_ap / n_classes
    lines.append(f"\n# mAP of all classes\nmAP = {mAP * 100:.2f}%\n")

    # detection counts (`utils/utils_map.py:703-742`); includes classes that
    # appear only in detection files (tp forced to 0 like the reference)
    lines.append("\n# Number of ground-truth objects per class\n")
    for cname in sorted(gt_counter):
        lines.append(f"{cname}: {gt_counter[cname]}\n")
    lines.append("\n# Number of detected objects per class\n")
    for cname in sorted(det_counter):
        n_det = det_counter[cname]
        n_tp = tp_counter.get(cname, 0)
        lines.append(f"{cname}: {n_det} (tp:{n_tp}, fp:{n_det - n_tp})\n")

    with open(os.path.join(results_path, "results.txt"), "w") as f:
        f.writelines(lines)

    if draw_plot:
        # reference summary bar plots (`utils/utils_map.py:745-807`)
        _plot_bars(gt_counter, "ground-truth\n(%d files and %d classes)"
                   % (n_images, n_classes), "Number of objects per class",
                   os.path.join(results_path, "ground-truth-info.png"),
                   "forestgreen", counts=True)
        _plot_bars(lamr_dict, "log-average miss rate",
                   "log-average miss rate",
                   os.path.join(results_path, "lamr.png"), "royalblue")
        _plot_bars(ap_dict, "mAP = %.2f%%" % (mAP * 100), "Average Precision",
                   os.path.join(results_path, "mAP.png"), "royalblue",
                   percent=True)

    print(f"mAP = {mAP * 100:.2f}%")
    return mAP


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _plot_pr(mrec, mpre, ap, class_name, results_path):
    plt = _plt()
    plt.plot(mrec, mpre, "-o")
    area_under_curve_x = mrec[:-1] + [mrec[-2], mrec[-1]]
    area_under_curve_y = mpre[:-1] + [0.0, mpre[-1]]
    plt.fill_between(area_under_curve_x, 0, area_under_curve_y, alpha=0.2,
                     edgecolor="r")
    plt.title(f"class: {class_name} AP = {ap * 100:.2f}%")
    plt.xlabel("Recall")
    plt.ylabel("Precision")
    plt.xlim([0.0, 1.0])
    plt.ylim([0.0, 1.05])
    os.makedirs(os.path.join(results_path, "AP"), exist_ok=True)
    plt.savefig(os.path.join(results_path, "AP", f"{class_name}.png"))
    plt.cla()
    plt.close("all")


def _plot_curve(scores, ys, class_name, subdir, ylabel, results_path,
                score_threshold):
    """Metric-vs-score-threshold curve (`utils/utils_map.py:662-688`)."""
    plt = _plt()
    plt.plot(scores, ys, "-", color={"F1": "orangered", "Recall": "gold",
                                     "Precision": "palevioletred"}[subdir])
    plt.title(f"class: {class_name} {ylabel}\nscore_threhold={score_threshold}")
    plt.xlabel("Score_Threhold")
    plt.ylabel(ylabel)
    plt.xlim([0.0, 1.0])
    plt.ylim([0.0, 1.05])
    os.makedirs(os.path.join(results_path, subdir), exist_ok=True)
    plt.savefig(os.path.join(results_path, subdir, f"{class_name}.png"))
    plt.cla()
    plt.close("all")


def _plot_bars(values: Dict[str, float], title: str, xlabel: str,
               output_path: str, color: str, counts: bool = False,
               percent: bool = False):
    """Horizontal per-class bar plot, sorted by value — the reference's
    `draw_plot_func` surface (`utils/utils_map.py:158-244`)."""
    plt = _plt()
    items = sorted(values.items(), key=lambda kv: kv[1])
    names = [k for k, _ in items]
    vals = [v for _, v in items]
    fig, ax = plt.subplots(figsize=(8, max(2, 0.5 * len(names) + 1.5)))
    ax.barh(range(len(names)), vals, color=color)
    for i, v in enumerate(vals):
        label = (str(int(v)) if counts else
                 f"{v * 100:.2f}%" if percent else f"{v:.2f}")
        ax.text(v, i, " " + label, va="center")
    ax.set_yticks(range(len(names)))
    ax.set_yticklabels(names)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    fig.tight_layout()
    fig.savefig(output_path)
    plt.close(fig)
