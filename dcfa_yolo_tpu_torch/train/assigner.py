"""Task-Aligned Assigner (`dcfa_yolo_tpu/train/assigner.py:36-174`, reference
`nets/yolo_training.py:75-225`) with static shapes.

Ground truth is padded to `max_boxes` with a validity mask.  Ties decide the
result, since most alignment metrics are exactly 0 (anchors outside every gt
box): the top-k is k passes of argmax that take the lowest index, like the
JAX package's (`torch.topk` promises no order among ties), and the
duplicate-index rule that also wipes masked rows is kept.  The multi-gt
resolution takes the first index of the maximum too.  The whole assignment
runs without gradient, like the reference's `@no_grad`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dcfa_yolo_tpu_torch.ops.boxes import bbox_iou


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # (b, A) int64
    target_bboxes: torch.Tensor  # (b, A, 4) xyxy
    target_scores: torch.Tensor  # (b, A, nc)
    fg_mask: torch.Tensor        # (b, A) bool
    target_gt_idx: torch.Tensor  # (b, A) int64


def select_candidates_in_gts(xy_centers: torch.Tensor, gt_bboxes: torch.Tensor,
                             eps: float = 1e-9) -> torch.Tensor:
    """(A, 2), (b, M, 4) → (b, M, A) bool: anchor center strictly inside the
    gt box (`nets/yolo_training.py:12-38`)."""
    lt = gt_bboxes[..., None, :2]
    rb = gt_bboxes[..., None, 2:]
    deltas = torch.cat([xy_centers[None, None] - lt, rb - xy_centers[None, None]],
                       dim=-1)
    return deltas.amin(dim=-1) > eps


def _one_hot(idx: torch.Tensor, n: int, dim: int, dtype) -> torch.Tensor:
    """One-hot of `idx` with the new axis of size n inserted at `dim`."""
    shape = list(idx.shape)
    shape.insert(dim, n)
    out = torch.zeros(shape, dtype=dtype, device=idx.device)
    return out.scatter_(dim, idx.unsqueeze(dim), 1)


def select_highest_overlaps(mask_pos: torch.Tensor, overlaps: torch.Tensor,
                            n_max_boxes: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Resolve anchors matched to several gts by the largest overlap
    (`nets/yolo_training.py:41-72`); argmax takes the first maximum, as
    `jnp.argmax` does."""
    fg_mask = mask_pos.sum(-2)
    mask_multi = (fg_mask[:, None, :] > 1).expand_as(mask_pos)
    is_max = _one_hot(overlaps.argmax(dim=1), n_max_boxes, 1, mask_pos.dtype)
    mask_pos = torch.where(mask_multi, is_max, mask_pos)
    fg_mask = mask_pos.sum(-2)
    return mask_pos.argmax(dim=-2), fg_mask, mask_pos


def iterative_topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis by k argmax
    passes; ties go to the lowest index (`assigner.py:64-79`)."""
    cur = x.clone()
    idxs = []
    for _ in range(k):
        j = cur.argmax(dim=-1, keepdim=True)
        idxs.append(j)
        cur.scatter_(-1, j, float("-inf"))
    return torch.cat(idxs, dim=-1)


class TaskAlignedAssigner:
    def __init__(self, topk: int = 10, num_classes: int = 80, alpha: float = 0.5,
                 beta: float = 6.0, eps: float = 1e-9):
        self.topk = topk
        self.num_classes = num_classes
        self.alpha = alpha
        self.beta = beta
        self.eps = eps

    @torch.no_grad()
    def __call__(self, pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes,
                 mask_gt) -> AssignResult:
        """pd_scores (b, A, nc) post-sigmoid, pd_bboxes (b, A, 4) xyxy in
        image units, anc_points (A, 2) image units, gt_labels (b, M, 1),
        gt_bboxes (b, M, 4), mask_gt (b, M, 1) 0/1."""
        b, a, nc = pd_scores.shape
        m = gt_bboxes.shape[1]
        mask_gt_b = mask_gt[..., 0] > 0

        align_metric, overlaps = self._box_metrics(pd_scores, pd_bboxes,
                                                   gt_labels, gt_bboxes)
        mask_in_gts = select_candidates_in_gts(anc_points, gt_bboxes)
        mask_topk = self._topk_mask(align_metric * mask_in_gts, mask_gt_b)
        mask_pos = mask_topk * mask_in_gts * mask_gt_b[..., None]

        target_gt_idx, fg_mask, mask_pos = select_highest_overlaps(
            mask_pos, overlaps, m)

        # targets (`get_targets`, nets/yolo_training.py:200-225)
        tl = gt_labels[..., 0].long().gather(1, target_gt_idx)
        tb = gt_bboxes.gather(1, target_gt_idx[..., None].expand(b, a, 4))
        target_scores = _one_hot(tl, nc, 2, pd_scores.dtype)
        target_scores = torch.where(fg_mask[..., None] > 0, target_scores, 0.0)

        # score normalization (`nets/yolo_training.py:126-134`)
        align_metric = align_metric * mask_pos
        pos_align_metrics = align_metric.amax(dim=-1, keepdim=True)
        pos_overlaps = (overlaps * mask_pos).amax(dim=-1, keepdim=True)
        norm_align = (align_metric * pos_overlaps
                      / (pos_align_metrics + self.eps)).amax(dim=-2)[..., None]
        return AssignResult(
            target_labels=tl, target_bboxes=tb,
            target_scores=target_scores * norm_align,
            fg_mask=fg_mask > 0, target_gt_idx=target_gt_idx)

    def _box_metrics(self, pd_scores, pd_bboxes, gt_labels, gt_bboxes):
        """(b, M, A) score^α · CIoU^β and the clamped CIoU
        (`get_box_metrics`, nets/yolo_training.py:150-173)."""
        gl = gt_labels[..., 0].long()  # (b, M)
        bbox_scores = pd_scores.gather(
            2, gl[:, None, :].expand(-1, pd_scores.shape[1], -1)).transpose(1, 2)
        overlaps = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :],
                            xywh=False, CIoU=True)[..., 0].clamp(min=0.0)
        return bbox_scores ** self.alpha * overlaps ** self.beta, overlaps

    def _topk_mask(self, metrics: torch.Tensor, mask_gt_b: torch.Tensor
                   ) -> torch.Tensor:
        """(b, M, A) metrics → (b, M, A) 0/1 top-k membership
        (`select_topk_candidates`, nets/yolo_training.py:175-198)."""
        topk_idxs = iterative_topk_indices(metrics, self.topk)
        topk_idxs = torch.where(mask_gt_b[..., None], topk_idxs, 0)
        is_in_topk = torch.zeros_like(metrics).scatter_add_(
            -1, topk_idxs, torch.ones_like(topk_idxs, dtype=metrics.dtype))
        # the duplicate-index rule also erases masked rows (their forced-0
        # indices collide when topk > 1)
        return torch.where(is_in_topk > 1, 0.0, is_in_topk)
