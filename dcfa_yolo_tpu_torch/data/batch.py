"""A batch on the device, as the train step takes it: what the loaders
hand the trainer (`data/device_aug.py`, `Trainer.put_batch`)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Batch(NamedTuple):
    rgb: torch.Tensor        # (B, H, W, 3) in [0, 1], compute dtype
    nir: torch.Tensor        # (B, H, W, 3)
    gt_boxes: torch.Tensor   # (B, M, 4) xyxy pixels
    gt_labels: torch.Tensor  # (B, M)
    gt_mask: torch.Tensor    # (B, M)
