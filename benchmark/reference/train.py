"""Plain reference of one train step: the train-mode forward (BatchNorm on
the batch, running statistics moved), the loss, the gradient, then the
optimizer and the EMA, per tensor in float32.  In a lower precision
(`ReferenceYolo.precision`) the network's forward and the whole backward
round every operation; the loss and the update stay float32, as the
program keeps them.

The optimizer is the recipe's SGD (`train_mul.py:240-259` of
https://github.com/heitieya/DCFA-YOLO, in optax's order as the port keeps
it): clip the global gradient norm to 10 as `(g / norm) · 10`, add
5e-4·p to the conv kernels' gradients, nesterov momentum 0.937
(trace ← 0.937·trace + g; update g + 0.937·trace), p ← p − lr·update.
The EMA covers every floating state entry with the decay ramp
0.9999·(1 − e^(−u/2000)) in float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from reference.loss import YoloLoss
from reference.model import ReferenceYolo
from reference.precision import rounding

MOMENTUM = 0.937
WEIGHT_DECAY = 5e-4
CLIP = 10.0
EMA_DECAY, EMA_TAU = 0.9999, 2000.0


def ema_decay(updates: int):
    f32 = np.float32
    d = f32(EMA_DECAY) * (f32(1.0) - np.exp(-f32(updates) / f32(EMA_TAU)))
    return float(d), float(f32(1.0) - d)


class ReferenceTrainer:
    """The model in train mode, the SGD trace and the EMA."""

    def __init__(self, model: ReferenceYolo, device):
        self.model = model.to(device).train()
        s = model.sizes
        self.loss = YoloLoss(s.num_classes, s.reg_max, s.input_hw, device)
        self.named = list(model.named_parameters())
        self.trace = {n: torch.zeros_like(p) for n, p in self.named}
        self.ema = {k: v.detach().float().clone() for k, v in model.state_dict().items()
                    if v.is_floating_point()}
        self.updates = 0

    def step(self, rgb, nir, gt_boxes, gt_labels, gt_mask, lr: float):
        """One step; returns the loss terms (total, box, cls, dfl) as
        floats."""
        lb = self.loss(self.model.train_feats(rgb, nir), gt_boxes, gt_labels, gt_mask)
        params = [p for _, p in self.named]
        with rounding(self.model.precision):
            grads = torch.autograd.grad(lb.total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
            if norm >= CLIP:
                grads = [g / norm * CLIP for g in grads]
            for (name, p), g in zip(self.named, grads):
                if name.rsplit(".", 1)[-1] == "weight" and p.dim() == 4:
                    g = g + p * WEIGHT_DECAY
                t = self.trace[name]
                t.mul_(MOMENTUM).add_(g)
                p.sub_((g + t * MOMENTUM) * lr)
            self.updates += 1
            d, one_minus_d = ema_decay(self.updates)
            sd = self.model.state_dict()
            for k, v in self.ema.items():
                v.mul_(d).add_(sd[k].float() * one_minus_d)
        return [float(t.detach()) for t in lb]

    @torch.no_grad()
    def load(self, state: Dict[str, torch.Tensor], trace: Dict[str, torch.Tensor],
             ema: Dict[str, torch.Tensor], updates: int) -> None:
        """Start from a given point of training, in the reference's layout:
        the parameters and BN statistics, the SGD trace, the EMA and its
        update count."""
        for k, v in self.model.state_dict().items():
            if v.is_floating_point():
                v.copy_(state[k])
        for n, t in self.trace.items():
            t.copy_(trace[n])
        for k, v in self.ema.items():
            v.copy_(ema[k])
        self.updates = int(updates)

    def state(self) -> Dict[str, torch.Tensor]:
        """Parameters, BN statistics and the EMA (prefixed `ema.`)."""
        out = {k: v.detach().clone() for k, v in self.model.state_dict().items()
               if v.is_floating_point()}
        out.update({f"ema.{k}": v.clone() for k, v in self.ema.items()})
        return out
