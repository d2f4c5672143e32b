"""Prediction decode and letterbox unmapping (`dcfa_yolo_tpu/infer/decode.py`,
reference `utils/utils_bbox.py:42-85`)."""

from __future__ import annotations

from typing import Tuple

import torch

from dcfa_yolo_tpu_torch.ops.boxes import dist2bbox


def decode_box(dbox: torch.Tensor, cls_logits: torch.Tensor,
               anchors: torch.Tensor, strides: torch.Tensor,
               input_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, A, 4) ltrb distances + (B, A, nc) logits → (B, A, 4+nc): xywh
    normalized to [0, 1] by the input shape, plus sigmoid scores."""
    xywh = dist2bbox(dbox, anchors[None], xywh=True) * strides[None]
    h, w = input_hw
    norm = torch.tensor([w, h, w, h], dtype=xywh.dtype, device=xywh.device)
    return torch.cat([xywh / norm, torch.sigmoid(cls_logits)], dim=-1)


def correct_boxes_yxyx(boxes_xyxy_norm: torch.Tensor,
                       input_hw: Tuple[int, int],
                       image_hw: torch.Tensor) -> torch.Tensor:
    """Normalized letterboxed-input xyxy → original-image-pixel
    [y1, x1, y2, x2] (`utils/utils_bbox.py:60-85`, including its y/x-swapped
    output order).  image_hw: (2,) or (B, 2) original (h, w)."""
    x1, y1, x2, y2 = boxes_xyxy_norm.chunk(4, dim=-1)
    box_yx = torch.cat([(y1 + y2) / 2, (x1 + x2) / 2], dim=-1)
    box_hw = torch.cat([y2 - y1, x2 - x1], dim=-1)

    dt, dev = boxes_xyxy_norm.dtype, boxes_xyxy_norm.device
    input_shape = torch.tensor(input_hw, dtype=dt, device=dev)
    image_shape = torch.as_tensor(image_hw, dtype=dt, device=dev)
    if image_shape.dim() == 2:  # (B, 2) → broadcast over detections
        image_shape = image_shape[:, None, :]

    new_shape = torch.round(image_shape * torch.amin(
        input_shape / image_shape, dim=-1, keepdim=True))
    offset = (input_shape - new_shape) / 2.0 / input_shape
    scale = input_shape / new_shape
    box_yx = (box_yx - offset) * scale
    box_hw = box_hw * scale

    boxes = torch.cat([box_yx - box_hw / 2.0, box_yx + box_hw / 2.0], dim=-1)
    return boxes * torch.cat([image_shape, image_shape], dim=-1)
