"""Pooling primitives (`dcfa_yolo_tpu/ops/pool.py:88-114`), NCHW tensors."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_same(x: torch.Tensor, kernel: int, stride: int = 1) -> torch.Tensor:
    """MaxPool2d(kernel, stride, padding=kernel//2), floor mode.

    The stem pool (k3 s2) and the SPPF pools (k5 s1).  Padded positions are
    -inf, so they never win the max.
    """
    return F.max_pool2d(x, kernel, stride, kernel // 2)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1): (B, C, H, W) → (B, C, 1, 1)."""
    return x.mean(dim=(2, 3), keepdim=True)


def global_max_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveMaxPool2d(1): (B, C, H, W) → (B, C, 1, 1)."""
    return x.amax(dim=(2, 3), keepdim=True)
