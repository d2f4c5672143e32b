"""BatchNorm with the JAX package's semantics and rounding
(`dcfa_yolo_tpu/ops/norm.py:47-86`), PyTorch's exact running update.

Eval mode folds the affine in float32 into a per-channel
`inv = rsqrt(var+eps)·γ` and `shift = β − mean·inv`, both cast to the
activation dtype, and applies them as one multiply-add in that dtype.

Train mode normalizes with the batch moments, computed in float32 over N, H
and W as `mean` and `mean²` with `var = max(mean² − mean², 0)`, normalizes in
float32 and casts to the activation dtype (the conv before it may hand over
its float32 sums, `ops/conv.py::conv_bn`).  Autograd differentiates that
formula as written, through the batch mean and variance.  The running
statistics move as in torch: `r ← (1−m)·r + m·stat`, the variance with the
Bessel factor n/(n−1).  `F.batch_norm` is not used: its variance and its
backward are other formulas, and in bfloat16 it rounds at other places.

With a process group (`BatchNorm.group`, the JAX module's `axis_name`,
`ops/norm.py:61-67`) the train-mode `mean` and `mean²` are averaged over
the ranks before the variance (SyncBN; equal local batches), and the Bessel
factor counts the global n.  Without one nothing is reduced.

Under `torch.utils.checkpoint` (`ModelConfig.remat`) the backward runs a
train-mode forward a second time; inside `recomputing()` the running
statistics do not move, so they take one momentum step a train step, as
flax's `nn.remat` keeps (it drops the recomputed `batch_stats`).

`nn.Module.train()` / `eval()` switch between the two.  Names follow
`torch.nn.BatchNorm2d` (weight/bias/running_mean/running_var) so the flax
tree maps onto it by renaming (`models/convert.py`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
from torch import nn

from dcfa_yolo_tpu_torch.parallel.mesh import all_reduce_mean, world_size


def batch_moments(xf: torch.Tensor, group=None):
    """Per-channel (mean, var) of a float32 NCHW tensor over N, H, W, as
    `ops/norm.py:59-67` of the JAX package computes them: the local `mean`
    and `mean²`, averaged over the ranks of `group` (differentiably), then
    `var = max(mean² − mean², 0)`."""
    mean = xf.mean(dim=(0, 2, 3))
    mean2 = (xf * xf).mean(dim=(0, 2, 3))
    if group is not None:
        mean, mean2 = all_reduce_mean(torch.stack([mean, mean2]), group).unbind(0)
    return mean, torch.clamp_min(mean2 - mean * mean, 0.0)


_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputing():
    """The context of a checkpointed forward's recompute (the second
    context of `torch.utils.checkpoint`'s `context_fn`): `update_running`
    does nothing inside it.  Per thread: the backward recomputes on the
    autograd engine's thread."""
    before = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = before


@torch.no_grad()
def update_running(bn: "BatchNorm", mean: torch.Tensor, var: torch.Tensor,
                   n: int) -> None:
    """torch's running update with momentum `bn.momentum` and the Bessel
    factor n/(n−1) on the variance (`ops/norm.py:68-73`); none while a
    checkpointed forward is recomputed (`recomputing`)."""
    if getattr(_RECOMPUTE, "on", False):
        return
    m = bn.momentum
    bessel = n / max(n - 1.0, 1.0)
    bn.running_mean.copy_((1.0 - m) * bn.running_mean + m * mean)
    bn.running_var.copy_((1.0 - m) * bn.running_var + m * var * bessel)


class BatchNorm(nn.Module):
    """Per-channel BatchNorm over dim 1 of an NCHW tensor.  `momentum` is
    torch's (the weight of the new batch statistic).  `group`: the process
    group whose ranks share the train-mode moments (None: local), set by
    `DCFAYolo.set_process_group`."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.group = None

    def folded(self):
        """(inv, shift) in float32, shape (C,)."""
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return inv, shift

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
        """`dtype`: the train-mode output's, when x is a conv's float32 sums
        (`ops/conv.py::conv_bn`); default x's."""
        shape = (1, -1, 1, 1)
        if not self.training:
            inv, shift = self.folded()
            return (x * inv.to(x.dtype).view(shape)
                    + shift.to(x.dtype).view(shape))
        xf = x.float()
        mean, var = batch_moments(xf, self.group)
        update_running(self, mean.detach(), var.detach(),
                       x.shape[0] * x.shape[2] * x.shape[3] * world_size(self.group))
        y = (xf - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(dtype or x.dtype)
