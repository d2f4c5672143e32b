"""Eval-mode BatchNorm with the JAX package's rounding (`ops/norm.py:47-57`
of `dcfa_yolo_tpu`).

The affine is folded in float32 into a per-channel `inv = rsqrt(var+eps)·γ`
and `shift = β − mean·inv`, both cast to the activation dtype, and applied as
one multiply-add in that dtype.  `nn.BatchNorm2d` in eval mode is not used:
in bfloat16 it rounds at other places.

Names follow `torch.nn.BatchNorm2d` (weight/bias/running_mean/running_var) so
the flax tree maps onto it by renaming (`models/convert.py`).
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Per-channel eval BatchNorm over dim 1 of an NCHW tensor."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def folded(self):
        """(inv, shift) in float32, shape (C,)."""
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return inv, shift

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv, shift = self.folded()
        shape = (1, -1, 1, 1)
        return (x * inv.to(x.dtype).view(shape)
                + shift.to(x.dtype).view(shape))
