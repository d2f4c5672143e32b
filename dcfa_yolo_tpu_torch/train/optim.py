"""The optimizer's parameter groups and constants
(`dcfa_yolo_tpu/train/optim.py:27-57`), which the flat optimizer
(`train/flat_opt.py`) builds its masks from.

The reference's three param groups (`train_mul.py:246-259`): weight decay
on conv kernels only (4-D `weight`s), none on BN weights, biases or
`bi_fpn.w`.  The reference never optimizes `bi_fpn.w`; the JAX package
trains it by default, and `train_bifpn=False` (the CLI's `--frozen-bifpn`)
zeroes its update as `optim.py:81-82` does.  In the freeze phase the
backbones' parameters take no step (`trainer.py:63-104`).
"""

from __future__ import annotations

import torch

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
