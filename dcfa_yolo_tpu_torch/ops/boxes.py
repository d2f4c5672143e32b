"""Anchors, box transforms and IoU variants (`dcfa_yolo_tpu/ops/boxes.py:20-117`,
reference `utils/utils_bbox.py:16-40`, `nets/yolo_training.py:227-320`)."""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def make_anchors_np(input_hw: Tuple[int, int],
                    strides: Tuple[int, ...] = (8, 16, 32),
                    grid_cell_offset: float = 0.5
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Grid anchor centers and per-anchor strides.

    Returns (anchor_points (A, 2) xy in feature units, stride_tensor (A, 1)).
    Levels in stride order, row-major within a level (x fastest), the
    reference's NCHW `.view(b, no, -1)` flatten order.
    """
    h, w = input_hw
    points, stride_vals = [], []
    for s in strides:
        fh, fw = h // s, w // s
        sx = np.arange(fw, dtype=np.float32) + grid_cell_offset
        sy = np.arange(fh, dtype=np.float32) + grid_cell_offset
        gy, gx = np.meshgrid(sy, sx, indexing="ij")
        points.append(np.stack([gx, gy], axis=-1).reshape(-1, 2))
        stride_vals.append(np.full((fh * fw, 1), s, dtype=np.float32))
    return np.concatenate(points, axis=0), np.concatenate(stride_vals, axis=0)


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


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """cxcywh → xyxy (`nets/yolo_training.py:305-320`)."""
    cx, cy, w, h = x.chunk(4, dim=-1)
    return torch.cat([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


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
