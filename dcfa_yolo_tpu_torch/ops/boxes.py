"""Anchors and the distance→box transform (`dcfa_yolo_tpu/ops/boxes.py:20-55`,
reference `utils/utils_bbox.py:16-40`)."""

from __future__ import annotations

import functools
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
