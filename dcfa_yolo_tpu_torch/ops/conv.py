"""Convolution blocks of the port (`dcfa_yolo_tpu/ops/conv.py:27-176`).

The reference model mixes two BatchNorm flavours: its `Conv` blocks use
eps=1e-3 (`nets/yolo_mul.py:197`), everything else (ShuffleNet, RepGhost,
C2fRepGhost's 1x1 convs, `nets/repghost.py:298`) uses eps=1e-5.  Only the
eval path is ported, so the momenta do not appear.

Parameters stay float32; each conv casts its weights to the activation dtype
when it runs, as flax's `nn.Conv(dtype=...)` does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dcfa_yolo_tpu_torch.ops.norm import BatchNorm


def autopad(k: int, p: Optional[int] = None, d: int = 1) -> int:
    """'same'-style padding used throughout the reference
    (`nets/yolo_mul.py:171-180`)."""
    if d > 1:
        k = d * (k - 1) + 1
    if p is None:
        p = k // 2
    return p


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU as `x·sigmoid(x)`, the JAX package's `apply_act(x, "silu")` (the
    only activation its eval graph applies through `apply_act`)."""
    return x * torch.sigmoid(x)


class Conv(nn.Conv2d):
    """`nn.Conv2d` with float32 parameters applied in the input's dtype."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 p: Optional[int] = None, g: int = 1, bias: bool = False):
        super().__init__(c_in, c_out, k, s, autopad(k, p), groups=g,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class ConvBnAct(nn.Module):
    """The reference's `Conv` block: bias-free conv + BN + SiLU.

    `bn_eps` defaults to the `nets/yolo_mul.py:197` flavour (1e-3);
    C2fRepGhost passes the torch default 1e-5.
    """

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 bn_eps: float = 1e-3):
        super().__init__()
        self.conv = Conv(c_in, c_out, k, s)
        self.bn = BatchNorm(c_out, eps=bn_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return silu(self.bn(self.conv(x)))
