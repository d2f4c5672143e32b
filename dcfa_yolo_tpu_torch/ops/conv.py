"""Convolution blocks of the port (`dcfa_yolo_tpu/ops/conv.py:27-176`).

The reference model mixes two BatchNorm flavours: its `Conv` blocks use
eps=1e-3 and momentum 0.03 (`nets/yolo_mul.py:197`), everything else (the
stem, ShuffleNet, RepGhost, C2fRepGhost's 1x1 convs, `nets/repghost.py:298`)
uses the torch defaults eps=1e-5 and momentum 0.1.  Momentum is torch's:
the weight of the new batch statistic in the running update.

Parameters stay float32; each conv casts its weights to the activation dtype
when it runs, as flax's `nn.Conv(dtype=...)` does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
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


def parts_conv(conv: Conv, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """conv(concat(parts, dim=1)) as Σ conv_i(part_i), the kernel's
    input-channel columns sliced per part (JAX `ops/conv.py:134-164`), so
    that the concat buffer is never written.  Only a 1x1 ungrouped conv
    splits this way.

    The JAX package takes each partial in float32, sums in float32 and
    rounds once to the activation dtype.  Here each part conv runs on
    float32 copies of the part and of its kernel slice, both already in the
    activation dtype: a bf16 value is exact in float32 (and in TF32), so the
    products are the bf16 ones, and only the float32 sum is rounded, once.
    The deviation from the concat conv is the K-split summation order."""
    if conv.kernel_size != (1, 1) or conv.groups != 1:
        raise ValueError("parts input needs a 1x1 ungrouped conv")
    total = sum(p.shape[1] for p in parts)
    if total != conv.in_channels:
        raise ValueError(f"parts channels {total} != conv in-channels "
                         f"{conv.in_channels}")
    dtype = parts[0].dtype
    y, o = None, 0
    for p in parts:
        ci = p.shape[1]
        w = conv.weight[:, o:o + ci].to(dtype).float()
        yi = F.conv2d(p.float(), w, stride=conv.stride)
        y = yi if y is None else y + yi
        o += ci
    return y.to(dtype)


class ConvBnAct(nn.Module):
    """The reference's `Conv` block: bias-free conv + BN + SiLU.

    `bn_eps`/`bn_momentum` default to the `nets/yolo_mul.py:197` flavour
    (1e-3, 0.03); C2fRepGhost passes the torch defaults (1e-5, 0.1).  A
    tuple or list input is the parts of a channel concat (`parts_conv`).
    """

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 bn_eps: float = 1e-3, bn_momentum: float = 0.03):
        super().__init__()
        self.conv = Conv(c_in, c_out, k, s)
        self.bn = BatchNorm(c_out, eps=bn_eps, momentum=bn_momentum)

    def forward(self, x: Union[torch.Tensor, Sequence[torch.Tensor]]) -> torch.Tensor:
        y = parts_conv(self.conv, x) if isinstance(x, (tuple, list)) else self.conv(x)
        return silu(self.bn(y))
