"""Convolution blocks of the port (`dcfa_yolo_tpu/ops/conv.py:27-176`).

The reference model mixes two BatchNorm flavours: its `Conv` blocks use
eps=1e-3 and momentum 0.03 (`nets/yolo_mul.py:197`), everything else (the
stem, ShuffleNet, RepGhost, C2fRepGhost's 1x1 convs, `nets/repghost.py:298`)
uses the torch defaults eps=1e-5 and momentum 0.1.  Momentum is torch's:
the weight of the new batch statistic in the running update.

Parameters stay float32; each conv casts its weights to the activation dtype
when it runs, as flax's `nn.Conv(dtype=...)` does.

Below float32, a bias-free conv hands a train-mode BatchNorm the float32
sums of its products (`conv_bn`), not their rounding to the activation
dtype.  That is the JAX bf16 train step as XLA compiles it for the CPU,
which has no bf16 convolution or dot: the `float-normalization-bf16` pass
rewrites them to float32 and, where the only users of the result are the
BN's casts to float32 (`dcfa_yolo_tpu/ops/norm.py:60,84`), drops the
rounding between.  Whether a TPU compile drops it is not shown.  In the
backward the cotangent is rounded to the activation dtype first (the VJP of
the BN's cast, which the compile keeps), the sums are float32, and the
input and weight gradients are each rounded once (the CPU compile leaves
the weight gradient's sums unrounded; the jaxpr rounds them).  The
ShuffleNet depthwise conv adds its bias in the activation dtype first, so
it stays rounded.  The stem is the exception: both of its train graphs keep
the Pallas stem's contract, the conv rounded before the statistics
(`ops/cuda_stem_train.py`, `models/blocks.py::ConvMaxpool`), which the
compiled XLA stem, the JAX CLI's default, does not.
"""

from __future__ import annotations

import contextlib
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

    def accumulate(self, x: torch.Tensor) -> torch.Tensor:
        """The float32 sums of the bias-free conv in x's dtype, before they
        are rounded (`_Accumulate`)."""
        return _Accumulate.apply(x, self.weight.to(x.dtype), self.stride,
                                 self.padding, self.groups)


class _Accumulate(torch.autograd.Function):
    """conv2d of x and w (both in the activation dtype) with float32 output:
    the float32 conv of their float32 copies, whose products are exact (a
    bf16 value is exact in float32 and in TF32, so cuDNN may take TF32
    whatever the global setting).  It keeps x and w in their own dtype for
    the backward, which rounds the cotangent to x's dtype, forms the float32
    copies again and rounds the input gradient once to x's dtype, the
    weight gradient to w's."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding, groups)
        with _tf32_convs():
            return F.conv2d(x.float(), w.float(), None, stride, padding, 1, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, groups = ctx.conv
        with _tf32_convs():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g.to(x.dtype).float(), x.float(), w.float(), None, stride, padding, (1, 1),
                False, (0, 0), groups, (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
        return (None if gx is None else gx.to(x.dtype),
                None if gw is None else gw.to(w.dtype), None, None, None)


@contextlib.contextmanager
def _tf32_convs():
    """cuDNN's TF32 allowed for the convs of `_Accumulate`, whose operands
    are all bf16 values."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def conv_bn(conv: Conv, bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """bn(conv(x)), a train-mode BN below float32 reading the float32 sums
    of a bias-free conv (module docstring)."""
    if bn.training and x.dtype != torch.float32 and conv.bias is None:
        return bn(conv.accumulate(x), x.dtype)
    return bn(conv(x))


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
        if isinstance(x, (tuple, list)):
            return silu(self.bn(parts_conv(self.conv, x)))
        return silu(conv_bn(self.conv, self.bn, x))
