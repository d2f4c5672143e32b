"""Exponential moving average of the model state (`dcfa_yolo_tpu/train/ema.py`,
reference `ModelEMA`, `nets/yolo_training.py:448-478`).

Like the reference, the EMA covers every floating entry of the state: the
parameters and the BatchNorm running statistics, with the decay ramp
d(u) = decay · (1 − e^(−u/τ)) computed in float32 as the JAX package does.
The update runs as multi-tensor `torch._foreach_*` ops.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def ema_decay(updates: int, decay: float, tau: float):
    """(d(u), 1 − d(u)) in float32 arithmetic (`ema.py:31-34`)."""
    f32 = np.float32
    d = f32(decay) * (f32(1.0) - np.exp(-f32(updates) / f32(tau)))
    return float(d), float(f32(1.0) - d)


class ModelEMA:
    """EMA of the floating entries of `model.state_dict()`, a fresh float32
    copy at init (`ema.py:21-27`)."""

    def __init__(self, model: nn.Module, updates: int = 0):
        self.updates = updates
        self.variables: Dict[str, torch.Tensor] = {
            k: v.detach().float().clone() for k, v in model.state_dict().items()
            if v.is_floating_point()}

    @torch.no_grad()
    def update(self, model: nn.Module, decay: float = 0.9999,
               tau: float = 2000.0) -> None:
        self.updates += 1
        d, one_minus_d = ema_decay(self.updates, decay, tau)
        sd = model.state_dict()
        ema = list(self.variables.values())
        live = [sd[k].float() for k in self.variables]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, torch._foreach_mul(live, one_minus_d))
