"""The optimizer of the train step (`dcfa_yolo_tpu/train/optim.py:36-85` and
its flat tail `train/flat_opt.py`), as multi-tensor `torch._foreach_*` ops.

The reference's three param groups (`train_mul.py:246-259`): weight decay
on conv kernels only (4-D `weight`s), none on BN weights, biases or
`bi_fpn.w`.  The reference never optimizes `bi_fpn.w`; the JAX package
trains it by default, and `train_bifpn=False` (the CLI's `--frozen-bifpn`)
zeroes its update as `optim.py:81-82` does.  The chain, in optax's order:

    clip_by_global_norm → coupled weight decay → nesterov trace | Adam
    → [bi_fpn update zeroed] → p ← p − lr·update

Clipping uses optax's formula, `(g / norm) · max_norm` when norm ≥ max_norm
(`clip_grad_norm_` would add 1e-6).  In the freeze phase the backbones'
parameters take no step, count in no norm and keep a zero optimizer state
(`trainer.py:63-104`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from dcfa_yolo_tpu_torch.config import TrainConfig

ADAM_B2 = 0.999
ADAM_EPS = 1e-8
FROZEN_SCOPES = ("backbone_rgb", "backbone_nir")


def decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay applies to conv kernels only (`optim.py:36-43`)."""
    return name.rsplit(".", 1)[-1] == "weight" and p.dim() == 4


def bifpn(name: str) -> bool:
    """The BiFPN fusion weights (`optim.py:55-57`)."""
    return "bi_fpn" in name.split(".")


def frozen(name: str) -> bool:
    """Inside one of the two modal backbones (`Freeze_Train`,
    `train_mul.py:231-237`)."""
    return any(s in FROZEN_SCOPES for s in name.split("."))


class Optimizer:
    """SGD with nesterov momentum or Adam over named float32 parameters."""

    def __init__(self, cfg: TrainConfig,
                 named_params: Sequence[Tuple[str, torch.Tensor]],
                 train_bifpn: bool = True):
        if cfg.optimizer_type not in ("sgd", "adam"):
            raise ValueError(cfg.optimizer_type)
        self.cfg = cfg
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.decay = [decays(n, p) for n, p in named_params]
        self.frozen = [frozen(n) for n in self.names]
        self.applied = [train_bifpn or not bifpn(n) for n in self.names]
        zeros = lambda: [torch.zeros_like(p) for p in self.params]
        if cfg.optimizer_type == "sgd":
            self.trace = zeros()
        else:
            self.count = 0
            self.mu, self.nu = zeros(), zeros()

    def state(self) -> Dict:
        """The optimizer state by parameter name."""
        if self.cfg.optimizer_type == "sgd":
            return {"trace": dict(zip(self.names, self.trace))}
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state(self, state: Dict) -> None:
        """Restore a `state()` (exact resume): copies into the slots."""
        if self.cfg.optimizer_type == "adam":
            self.count = int(state["count"])
        for key, slot in zip(("trace",) if self.cfg.optimizer_type == "sgd"
                             else ("mu", "nu"), self._slots()):
            for name, t in zip(self.names, slot):
                t.copy_(state[key][name])

    def _slots(self) -> List[List[torch.Tensor]]:
        return [self.trace] if self.cfg.optimizer_type == "sgd" else [self.mu, self.nu]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float,
             freeze_backbone: bool = False) -> None:
        cfg = self.cfg
        live = [i for i in range(len(self.params))
                if not (freeze_backbone and self.frozen[i])]
        if freeze_backbone:
            for slot in self._slots():
                torch._foreach_zero_([slot[i] for i in range(len(slot))
                                      if self.frozen[i]])
        g = [grads[i].float() for i in live]
        p = [self.params[i] for i in live]
        if cfg.grad_clip_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            under = norm < cfg.grad_clip_norm
            # g unchanged below the limit, else (g / norm) · max_norm
            g = torch._foreach_mul(
                torch._foreach_div(g, torch.where(under, 1.0, norm)),
                torch.where(under, 1.0, cfg.grad_clip_norm))
        else:
            g = [t.clone() for t in g]
        if cfg.weight_decay > 0:
            dec = [j for j, i in enumerate(live) if self.decay[i]]
            torch._foreach_add_([g[j] for j in dec], [p[j] for j in dec],
                                alpha=cfg.weight_decay)
        if cfg.optimizer_type == "sgd":
            trace = [self.trace[i] for i in live]
            torch._foreach_mul_(trace, cfg.momentum)
            torch._foreach_add_(trace, g)
            upd = (torch._foreach_add(g, torch._foreach_mul(trace, cfg.momentum))
                   if cfg.nesterov else trace)
        else:
            b1, b2 = cfg.momentum, ADAM_B2
            self.count += 1
            mu = [self.mu[i] for i in live]
            nu = [self.nu[i] for i in live]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
            f32 = np.float32
            c = f32(self.count)
            bc1 = float(f32(1.0) - f32(b1) ** c)
            bc2 = float(f32(1.0) - f32(b2) ** c)
            den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(den, ADAM_EPS)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        on = [j for j, i in enumerate(live) if self.applied[i]]
        torch._foreach_sub_([p[j] for j in on],
                            torch._foreach_mul([upd[j] for j in on], lr))
