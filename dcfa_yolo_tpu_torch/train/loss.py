"""YOLOv8 training criterion (`dcfa_yolo_tpu/train/loss.py`, reference
`nets/yolo_training.py:323-430`) in fixed shapes.

Ground truth arrives padded to (b, max_boxes) with a validity mask
(`pad_targets` builds it on the host); masking replaces the reference's
boolean indexing with the same numerics.  The feats are cast to float32
first, and every term is computed in float32.

With a process group (`YoloLoss(group=)`, data-parallel fused training)
the normaliser `target_scores.sum()` is that of the global batch, as in the
JAX fused program over a sharded batch (`loss.py:113`): the sum over the
ranks, clamped to 1 after it.  Each rank's loss is then its part of the
global loss, and the parts add up to it.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
from dcfa_yolo_tpu_torch.ops.boxes import (bbox2dist, bbox_iou, dist2bbox,
                                           make_anchors_np)
from dcfa_yolo_tpu_torch.parallel.mesh import all_reduce_sum
from dcfa_yolo_tpu_torch.train.assigner import TaskAlignedAssigner


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor


def _df_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss (`nets/yolo_training.py:294-303`).
    pred_dist (..., 4, reg_max) logits; target (..., 4) continuous ltrb in
    [0, reg_max − 1).  Returns (..., 1): the mean over the 4 sides of the
    weighted left/right cross-entropies."""
    r = pred_dist.shape[-1]
    tl = target.floor().long()
    tr = (tl + 1).clamp(0, r - 1)
    wl = (tl + 1).to(target.dtype) - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist, dim=-1)
    ce_l = -logp.gather(-1, tl[..., None])[..., 0]
    ce_r = -logp.gather(-1, tr[..., None])[..., 0]
    return (ce_l * wl + ce_r * wr).mean(dim=-1, keepdim=True)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE-with-logits in the JAX package's form
    (`optax_sigmoid_bce`, `loss.py:139-141`)."""
    return (torch.clamp_min(logits, 0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


class YoloLoss:
    """Criterion bound to a model config; anchors and strides live on
    `device`.  `group`: normalise by the global batch's target scores."""

    def __init__(self, cfg: ModelConfig, train_cfg: TrainConfig = TrainConfig(),
                 device="cpu", group=None):
        self.cfg = cfg
        self.group = group
        self.tc = train_cfg
        self.nc = cfg.num_classes
        self.reg_max = cfg.reg_max
        self.use_dfl = cfg.reg_max > 1
        anchors, strides = make_anchors_np(tuple(cfg.input_shape), cfg.strides)
        self.anchor_points = torch.from_numpy(anchors).to(device)  # (A, 2)
        self.stride_tensor = torch.from_numpy(strides).to(device)  # (A, 1)
        self.proj = torch.arange(cfg.reg_max, dtype=torch.float32, device=device)
        self.assigner = TaskAlignedAssigner(
            topk=train_cfg.assigner_topk, num_classes=self.nc,
            alpha=train_cfg.assigner_alpha, beta=train_cfg.assigner_beta)

    def bbox_decode(self, pred_dist: torch.Tensor) -> torch.Tensor:
        """(b, A, 4·reg_max) logits → (b, A, 4) xyxy in feature units
        (`nets/yolo_training.py:360-369`)."""
        b, a, c = pred_dist.shape
        if self.use_dfl:
            x = pred_dist.reshape(b, a, 4, c // 4).softmax(dim=-1)
            pred_dist = (x * self.proj).sum(dim=-1)
        return dist2bbox(pred_dist, self.anchor_points[None], xywh=False)

    def __call__(self, feats: Sequence[torch.Tensor], gt_boxes: torch.Tensor,
                 gt_labels: torch.Tensor, gt_mask: torch.Tensor) -> LossBreakdown:
        """feats: per-level NHWC raw maps (b, h, w, 4·reg_max + nc);
        gt_boxes (b, M, 4) xyxy image pixels; gt_labels (b, M); gt_mask
        (b, M) 0/1 validity."""
        b = feats[0].shape[0]
        no = 4 * self.reg_max + self.nc
        flat = torch.cat([f.reshape(b, -1, no) for f in feats], dim=1).float()
        pred_distri = flat[..., :4 * self.reg_max]
        pred_scores = flat[..., 4 * self.reg_max:]
        pred_bboxes = self.bbox_decode(pred_distri)

        assign = self.assigner(
            pred_scores.detach().sigmoid(),
            (pred_bboxes.detach() * self.stride_tensor).to(gt_boxes.dtype),
            self.anchor_points * self.stride_tensor,
            gt_labels[..., None].float(), gt_boxes,
            gt_mask[..., None].float())
        target_bboxes = assign.target_bboxes / self.stride_tensor
        target_scores = assign.target_scores
        fg_mask = assign.fg_mask
        # the assigner's outputs are detached: a plain sum over the ranks
        target_scores_sum = torch.clamp_min(
            all_reduce_sum(target_scores.sum(), self.group), 1.0)

        # BCE cls (`nets/yolo_training.py:420`)
        loss_cls = sigmoid_bce(pred_scores, target_scores).sum() / target_scores_sum

        # CIoU box + DFL (`BboxLoss`, nets/yolo_training.py:272-303), fg-masked
        weight = torch.where(fg_mask, target_scores.sum(-1), 0.0)[..., None]
        iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False, CIoU=True)
        loss_box = torch.where(fg_mask[..., None], (1.0 - iou) * weight, 0.0)
        loss_box = loss_box.sum() / target_scores_sum

        if self.use_dfl:
            target_ltrb = bbox2dist(self.anchor_points[None], target_bboxes,
                                    float(self.reg_max - 1))
            dist_logits = pred_distri.reshape(b, -1, 4, self.reg_max)
            dfl = _df_loss(dist_logits, target_ltrb) * weight
            loss_dfl = torch.where(fg_mask[..., None], dfl, 0.0).sum() / target_scores_sum
        else:
            loss_dfl = torch.zeros((), device=flat.device)

        total = (self.tc.box_gain * loss_box + self.tc.cls_gain * loss_cls
                 + self.tc.dfl_gain * loss_dfl)
        return LossBreakdown(total=total, box=loss_box, cls=loss_cls, dfl=loss_dfl)


def pad_targets(labels: np.ndarray, batch_size: int, max_boxes: int,
                input_hw: Tuple[int, int]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side target preprocessing (`Loss.preprocess`,
    nets/yolo_training.py:342-358; `loss.py:144-176`).

    labels: (N, 6) rows [img_idx, cls, cx, cy, w, h], normalized coords.
    Returns (gt_boxes (b, M, 4) xyxy pixels, gt_labels (b, M), gt_mask
    (b, M)).  An image with more than max_boxes boxes keeps the largest."""
    h, w = input_hw
    gt_boxes = np.zeros((batch_size, max_boxes, 4), np.float32)
    gt_labels = np.zeros((batch_size, max_boxes), np.float32)
    gt_mask = np.zeros((batch_size, max_boxes), np.float32)
    for j in range(batch_size):
        rows = labels[labels[:, 0] == j]
        if len(rows) > max_boxes:
            rows = rows[np.argsort(-(rows[:, 4] * rows[:, 5]))[:max_boxes]]
        n = len(rows)
        if n == 0:
            continue
        cx, cy = rows[:n, 2] * w, rows[:n, 3] * h
        bw, bh = rows[:n, 4] * w, rows[:n, 5] * h
        gt_boxes[j, :n, 0] = cx - bw / 2
        gt_boxes[j, :n, 1] = cy - bh / 2
        gt_boxes[j, :n, 2] = cx + bw / 2
        gt_boxes[j, :n, 3] = cy + bh / 2
        gt_labels[j, :n] = rows[:n, 1]
        # the reference marks validity by box-sum > 0 (`nets/yolo_training.py:405`)
        gt_mask[j, :n] = (np.abs(gt_boxes[j, :n]).sum(-1) > 0).astype(np.float32)
    return gt_boxes, gt_labels, gt_mask
