"""Plain reference of the training criterion: the YOLOv8 loss (BCE
classes, CIoU boxes, DFL) over the task-aligned assigner, in float32.

A frozen copy of the port's `train/loss.py`, `train/assigner.py` and the
box arithmetic of `ops/boxes.py` (reference `nets/yolo_training.py:12-430`
of https://github.com/heitieya/DCFA-YOLO), without the data-parallel
normaliser: ground truth padded to a fixed count with a validity mask,
top-k by argmax passes (ties to the lowest index), every term in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from reference.model import make_anchors

def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor,
              xywh: bool = True) -> torch.Tensor:
    """ltrb distances (..., 4) → xywh or xyxy boxes (..., 4)."""
    lt, rb = distance.chunk(2, dim=-1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor,
              reg_max: float) -> torch.Tensor:
    """xyxy box → ltrb distances clamped to [0, reg_max − 0.01]
    (`nets/yolo_training.py:267-270`)."""
    x1y1, x2y2 = bbox.chunk(2, dim=-1)
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points],
                     dim=-1).clamp(0.0, reg_max - 0.01)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True,
             GIoU: bool = False, DIoU: bool = False, CIoU: bool = False,
             eps: float = 1e-7) -> torch.Tensor:
    """IoU / GIoU / DIoU / CIoU with the reference's epsilon placement
    (`nets/yolo_training.py:227-265`).  Inputs broadcast; the last dim is 4;
    the result keeps a trailing singleton dim.  CIoU's α carries no
    gradient, as in the reference."""
    if xywh:
        x1, y1, w1, h1 = box1.chunk(4, dim=-1)
        x2, y2, w2, h2 = box2.chunk(4, dim=-1)
        b1_x1, b1_x2 = x1 - w1 / 2, x1 + w1 / 2
        b1_y1, b1_y2 = y1 - h1 / 2, y1 + h1 / 2
        b2_x1, b2_x2 = x2 - w2 / 2, x2 + w2 / 2
        b2_y1, b2_y2 = y2 - h2 / 2, y2 + h2 / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.chunk(4, dim=-1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.chunk(4, dim=-1)
        w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
        w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps

    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if CIoU or DIoU or GIoU:
        cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
        ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
        if CIoU or DIoU:
            c2 = cw ** 2 + ch ** 2 + eps
            rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2
                    + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
            if CIoU:
                v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
                with torch.no_grad():
                    alpha = v / (v - iou + (1 + eps))
                return iou - (rho2 / c2 + v * alpha)
            return iou - rho2 / c2
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    return iou


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
    """Criterion for one model's sizes; anchors and strides live on
    `device`."""

    def __init__(self, num_classes: int, reg_max: int, input_hw, device="cpu",
                 gains=(7.5, 0.5, 1.5), topk=10, alpha=0.5, beta=6.0):
        self.box_gain, self.cls_gain, self.dfl_gain = gains
        self.nc = num_classes
        self.reg_max = reg_max
        self.use_dfl = reg_max > 1
        anchors, strides = make_anchors(tuple(input_hw))
        self.anchor_points = torch.from_numpy(anchors).to(device)  # (A, 2)
        self.stride_tensor = torch.from_numpy(strides).to(device)  # (A, 1)
        self.proj = torch.arange(reg_max, dtype=torch.float32, device=device)
        self.assigner = TaskAlignedAssigner(topk=topk, num_classes=self.nc,
                                            alpha=alpha, beta=beta)

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
        target_scores_sum = torch.clamp_min(target_scores.sum(), 1.0)

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

        total = (self.box_gain * loss_box + self.cls_gain * loss_cls
                 + self.dfl_gain * loss_dfl)
        return LossBreakdown(total=total, box=loss_box, cls=loss_cls, dfl=loss_dfl)
