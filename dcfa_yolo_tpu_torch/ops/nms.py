"""Fixed-shape batched non-maximum suppression (`dcfa_yolo_tpu/ops/nms.py`).

Candidates are the top-k of the conf-masked scores; classes are separated
with the batched-NMS coordinate offset (`2·max|coord|+1` over all of the
image's anchors); the greedy suppression runs in `ops/cuda_nms.py`.

Top-k is a stable descending sort and a slice: `jax.lax.top_k` puts the
lower index first among equal values, `torch.topk` promises no order, and
bf16 logits make equal scores common — a different order among ties would
change the greedy result.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dcfa_yolo_tpu_torch.ops.cuda_nms import greedy_suppress, greedy_suppress_plain


class NMSResult(NamedTuple):
    boxes: torch.Tensor    # (B, max_det, 4) xyxy, same units as input boxes
    scores: torch.Tensor   # (B, max_det); 0 for empty slots
    classes: torch.Tensor  # (B, max_det) int32; -1 for empty slots
    valid: torch.Tensor    # (B, max_det) bool
    # (B,) int32: candidates at/above conf_thres BEFORE the pre_nms_topk cut
    # (the reference NMS is uncapped; callers count when the cap binds)
    n_candidates: Optional[torch.Tensor] = None


def _topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _select_candidates(boxes, scores, classes, conf_thres: torch.Tensor,
                       k: int):
    """Per-image top-k candidates and their class-offset boxes (batched)."""
    coord_scale = 2.0 * boxes.abs().amax(dim=(1, 2)) + 1.0          # (B,)
    masked = torch.where(scores >= conf_thres, scores, -1.0)
    top_scores, idx = _topk_stable(masked, k)
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    top_classes = torch.gather(classes, 1, idx)
    alive = top_scores > 0.0
    off = (top_classes.to(boxes.dtype) * coord_scale[:, None])[..., None]
    return top_boxes, top_scores, top_classes, alive, top_boxes + off


def _finalize(keep, top_boxes, top_scores, top_classes, max_det: int):
    k = top_scores.shape[-1]
    if k < max_det:
        # fewer candidates than output slots: pad with always-invalid slots
        pad = max_det - k
        keep = torch.nn.functional.pad(keep, (0, pad), value=False)
        top_scores = torch.nn.functional.pad(top_scores, (0, pad), value=-1.0)
        top_boxes = torch.nn.functional.pad(top_boxes, (0, 0, 0, pad))
        top_classes = torch.nn.functional.pad(top_classes, (0, pad), value=-1)
    final_scores = torch.where(keep, top_scores, -1.0)
    out_scores, out_idx = _topk_stable(final_scores, max_det)
    valid = out_scores > 0.0
    out_boxes = torch.gather(top_boxes, 1, out_idx[..., None].expand(-1, -1, 4))
    out_boxes = torch.where(valid[..., None], out_boxes, 0.0)
    out_classes = torch.where(valid, torch.gather(top_classes, 1, out_idx), -1)
    out_scores = torch.where(valid, out_scores, 0.0)
    return out_boxes, out_scores, out_classes, valid


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, conf_thres: float, iou_thres: float,
                pre_nms_topk: int = 1024, max_det: int = 300,
                backend: str = "auto") -> NMSResult:
    """Batch NMS.  boxes (B, A, 4) float32 xyxy, scores (B, A), classes (B, A).

    backend 'kernel': the CUDA suppression kernel (its plain twin on a CPU
    tensor); 'plain': the plain PyTorch suppression; 'auto': the kernel on a
    CUDA tensor, the plain version on a CPU one.
    """
    if backend == "auto":
        backend = "kernel" if boxes.is_cuda else "plain"
    if backend not in ("kernel", "plain"):
        raise ValueError(f"unknown NMS backend {backend!r}")
    suppress = greedy_suppress if backend == "kernel" else greedy_suppress_plain
    conf = torch.tensor(conf_thres, dtype=scores.dtype, device=scores.device)
    n_cand = (scores >= conf).sum(dim=-1).to(torch.int32)
    classes = classes.to(torch.int32)
    k = min(pre_nms_topk, boxes.shape[1])
    top_boxes, top_scores, top_classes, alive, off_boxes = _select_candidates(
        boxes, scores, classes, conf, k)
    keep = suppress(off_boxes.contiguous(), alive, iou_thres) & alive
    out = _finalize(keep, top_boxes, top_scores, top_classes, max_det)
    return NMSResult(*out, n_candidates=n_cand)
