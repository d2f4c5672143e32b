"""Model blocks of the port (`dcfa_yolo_tpu/models/blocks.py`), eval graph.

Tensors are NCHW inside the model.  Submodule names follow the flax scopes
of the JAX package so that `models/convert.py` maps the flax tree by
flattening it.  Reproduced reference quirks carry their `nets/*.py:line`
citation, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from dcfa_yolo_tpu_torch.ops.conv import Conv, ConvBnAct, silu
from dcfa_yolo_tpu_torch.ops.norm import BatchNorm
from dcfa_yolo_tpu_torch.ops.pool import (global_avg_pool, global_max_pool,
                                          max_pool_same)


class ChannelAttention(nn.Module):
    """Channel gate: shared 1x1 MLP over avg+max pooled stats
    (`nets/yolo_mul.py:56-73`).  SPPF passes ratio=channels, collapsing the
    bottleneck to 1 channel (`nets/yolo_mul.py:18-21` quirk)."""

    def __init__(self, c: int, ratio: int = 8):
        super().__init__()
        self.fc1 = Conv(c, c // ratio, 1)
        self.fc2 = Conv(c // ratio, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg_out = self.fc2(torch.relu(self.fc1(global_avg_pool(x))))
        max_out = self.fc2(torch.relu(self.fc1(global_max_pool(x))))
        return torch.sigmoid(avg_out + max_out)


class SpatialAttention(nn.Module):
    """Spatial gate: channel mean+max → 7x7 conv → sigmoid
    (`nets/yolo_mul.py:76-90`)."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv1 = Conv(2, 1, kernel_size, p=3 if kernel_size == 7 else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv1(y))


class CBAM(nn.Module):
    """Channel-then-spatial multiplicative attention (`nets/yolo_mul.py:93-102`)."""

    def __init__(self, c: int, ratio: int = 8, kernel_size: int = 7):
        super().__init__()
        self.channelattention = ChannelAttention(c, ratio)
        self.spatialattention = SpatialAttention(kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * self.channelattention(x)
        return x * self.spatialattention(x)


class ConvMaxpool(nn.Module):
    """Stem: 3x3 s1 conv + default-BN + ReLU, then 3x3 s2 maxpool
    (`nets/yolo_mul.py:104-115`), eval XLA form (`blocks.py:129-134`).
    The serving kernel path replaces it with `ops/cuda_stem.py`."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv = Conv(c_in, c_out, 3, 1)
        self.bn = BatchNorm(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_same(torch.relu(self.bn(self.conv(x))), 3, 2)


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Interleave channel groups (`nets/yolo_mul.py:164-168`)."""
    n, c, h, w = x.shape
    return (x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
            .reshape(n, c, h, w))


class ShuffleNetV2Block(nn.Module):
    """Stride-1 ShuffleNetV2 unit (`nets/yolo_mul.py:118-168`): channel
    split, identity ∥ (1x1 → 3x3 dw → 1x1), concat, shuffle.  Quirk kept:
    the depthwise conv has bias=True (torch default at line 144) while the
    1x1 convs are bias-free.  The backbone uses only stride 1."""

    def __init__(self, c: int):
        super().__init__()
        bf = c // 2
        self.b2_conv1 = Conv(bf, bf, 1)
        self.b2_bn1 = BatchNorm(bf)
        self.b2_dwconv = Conv(bf, bf, 3, 1, g=bf, bias=True)
        self.b2_bn2 = BatchNorm(bf)
        self.b2_conv3 = Conv(bf, bf, 1)
        self.b2_bn3 = BatchNorm(bf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = x.chunk(2, dim=1)
        y = torch.relu(self.b2_bn1(self.b2_conv1(x2)))
        y = self.b2_bn2(self.b2_dwconv(y))
        y = torch.relu(self.b2_bn3(self.b2_conv3(y)))
        return channel_shuffle(torch.cat([x1, y], dim=1), 2)


class SPPFCBAM(nn.Module):
    """SPPF with CBAM after the 1x1 reduce and after each pooled scale
    (`nets/yolo_mul.py:10-32`).  Quirk kept: the inner CBAMs are built as
    `CBAM(c_, c_)`, so their channel-attention ratio equals the channel
    count."""

    def __init__(self, c_in: int, c_out: int, pool_kernel: int = 5):
        super().__init__()
        c_ = c_in // 2
        self.pool_kernel = pool_kernel
        self.cv1 = ConvBnAct(c_in, c_, 1, 1)
        self.cbam1 = CBAM(c_, ratio=c_)
        self.cbam2 = CBAM(c_, ratio=c_)
        self.cbam3 = CBAM(c_, ratio=c_)
        self.cbam4 = CBAM(c_, ratio=c_)
        self.cv2 = ConvBnAct(4 * c_, c_out, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.pool_kernel
        x = self.cbam1(self.cv1(x))
        y1 = self.cbam2(max_pool_same(x, k, 1))
        y2 = self.cbam3(max_pool_same(y1, k, 1))
        y3 = self.cbam4(max_pool_same(y2, k, 1))
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


class ConcatBiFPN(nn.Module):
    """Weighted concat of three maps: learnable scalar weights normalized by
    sum+1e-4, cast to the activation dtype, inputs scaled then concatenated
    (`nets/yolo_mul.py:36-51`)."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(3))

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        w = self.w / (self.w.sum() + 1e-4)
        w = w.to(xs[0].dtype)
        return torch.cat([w[0] * xs[0], w[1] * xs[1], w[2] * xs[2]], dim=1)


class RepGhostModule(nn.Module):
    """RepGhost, train graph (deploy=False, `nets/repghost.py:70-115`):
    primary 1x1 conv+BN(+SiLU) → cheap 3x3 depthwise conv+BN plus the
    fusion-BN of the primary output."""

    def __init__(self, c_in: int, c_out: int, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.primary_conv = Conv(c_in, c_out, 1, p=0)
        self.primary_bn = BatchNorm(c_out)
        self.cheap_conv = Conv(c_out, c_out, 3, 1, p=1, g=c_out)
        self.cheap_bn = BatchNorm(c_out)
        self.fusion_bn = BatchNorm(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.primary_bn(self.primary_conv(x))
        if self.relu:
            x1 = silu(x1)
        x2 = self.cheap_bn(self.cheap_conv(x1)) + self.fusion_bn(x1)
        if self.relu:
            x2 = silu(x2)
        return x2


class RepGhostBottleneck(nn.Module):
    """RepGhost bottleneck as C2fRepGhost uses it (`nets/repghost.py:178-279`):
    ghost expand → ghost project (no act) → + identity shortcut (in = out
    channels, stride 1, no SE)."""

    def __init__(self, c: int):
        super().__init__()
        self.ghost1 = RepGhostModule(c, c, relu=True)
        self.ghost2 = RepGhostModule(c, c, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ghost2(self.ghost1(x)) + x


class C2fRepGhost(nn.Module):
    """CSP block over RepGhost bottlenecks (`nets/repghost.py:308-320`).  Its
    1x1 convs use the default-BN flavour (eps 1e-5, `nets/repghost.py:291-305`)."""

    def __init__(self, c_in: int, c_out: int, n: int = 1,
                 expansion: float = 0.5):
        super().__init__()
        self.c = int(c_out * expansion)
        self.n = n
        self.cv1 = ConvBnAct(c_in, 2 * self.c, 1, 1, bn_eps=1e-5)
        for i in range(n):
            self.add_module(f"m{i}", RepGhostBottleneck(self.c))
        self.cv2 = ConvBnAct((2 + n) * self.c, c_out, 1, 1, bn_eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = list(self.cv1(x).split(self.c, dim=1))
        for i in range(self.n):
            y.append(getattr(self, f"m{i}")(y[-1]))
        return self.cv2(torch.cat(y, dim=1))


def dfl_decode(box_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution Focal Loss decode (`nets/yolo_mul.py:312-322`): softmax
    over reg_max bins per side → expectation.  (..., A, 4·reg_max) →
    (..., A, 4), computed in the input's dtype (float32 on the model path)
    as two reductions of one exp chain, like `blocks.py:286-303`."""
    x = box_logits.reshape(*box_logits.shape[:-1], 4, reg_max)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    proj = torch.arange(reg_max, dtype=x.dtype, device=x.device)
    return (e * proj).sum(dim=-1) / e.sum(dim=-1)
