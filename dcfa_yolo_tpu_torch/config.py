"""Configuration: the port's own copy of `dcfa_yolo_tpu/config.py`'s
`ModelConfig`, phi tables (`nets/yolo_mul.py:328-395` of the reference) and
`TrainConfig` (`train_mul.py:22-110`).

Kept are the fields the serving path and the single-device train step
read; `remat` and the data, eval and predict configs are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

DEPTH_DICT = {"n": 0.33, "s": 0.33, "m": 0.67, "l": 1.00, "x": 1.00}
WIDTH_DICT = {"n": 0.25, "s": 0.50, "m": 0.75, "l": 1.00, "x": 1.25}
DEEP_WIDTH_DICT = {"n": 1.00, "s": 1.00, "m": 0.75, "l": 0.50, "x": 0.50}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters."""

    num_classes: int = 1
    phi: str = "n"
    input_shape: Tuple[int, int] = (640, 640)  # (H, W)
    reg_max: int = 16
    # Compute dtype of the forward pass ("float32" or "bfloat16").  Parameters
    # and BN statistics always stay float32.
    compute_dtype: str = "float32"
    # Train-mode stem: "kernel" (the fused train-stem kernel,
    # ops/cuda_stem_train.py; the JAX package's "pallas"), "plain" (conv,
    # train-BN, ReLU and max pool as separate ops; its "xla") or "auto"
    # (the kernel wherever it applies, ops/cuda_stem_train.py::resolve_train_stem).
    # The parameter tree is the same for both.
    train_stem_backend: str = "auto"

    @property
    def depth_mul(self) -> float:
        return DEPTH_DICT[self.phi]

    @property
    def width_mul(self) -> float:
        return WIDTH_DICT[self.phi]

    @property
    def deep_mul(self) -> float:
        return DEEP_WIDTH_DICT[self.phi]

    @property
    def base_channels(self) -> int:
        return int(self.width_mul * 64)

    @property
    def base_depth(self) -> int:
        return max(round(self.depth_mul * 3), 1)

    @property
    def deep_channels(self) -> int:
        return int(self.base_channels * 16 * self.deep_mul)

    @property
    def feat_channels(self) -> Tuple[int, int, int]:
        """Channels of the three pyramid levels (P3, P4, P5)."""
        bc = self.base_channels
        return (bc * 4, bc * 8, self.deep_channels)

    @property
    def strides(self) -> Tuple[int, int, int]:
        return (8, 16, 32)

    @property
    def no(self) -> int:
        return self.num_classes + self.reg_max * 4


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training recipe (`train_mul.py:22-110`, `nets/yolo_training.py`); the
    fields the train step reads, with the JAX package's defaults."""

    batch_size: int = 16
    optimizer_type: str = "sgd"  # "sgd" | "adam"
    init_lr: float = 1e-2
    min_lr_ratio: float = 0.01
    momentum: float = 0.937
    nesterov: bool = True
    weight_decay: float = 5e-4
    grad_clip_norm: float = 10.0
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0
    # loss gains (`nets/yolo_training.py:427-429`)
    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    # assigner (`nets/yolo_training.py:334-338`)
    assigner_topk: int = 10
    assigner_alpha: float = 0.5
    assigner_beta: float = 6.0
    # fixed per-image padding of the ground-truth boxes
    max_boxes: int = 64

    def scaled_lrs(self, batch_size: Optional[int] = None) -> Tuple[float, float]:
        """lr scaling by batch/64 with clamps (`train_mul.py:240-244`)."""
        bs = self.batch_size if batch_size is None else batch_size
        nbs = 64
        lr_limit_max = 1e-3 if self.optimizer_type == "adam" else 5e-2
        lr_limit_min = 3e-4 if self.optimizer_type == "adam" else 5e-4
        init_lr_fit = min(max(bs / nbs * self.init_lr, lr_limit_min), lr_limit_max)
        min_lr_fit = min(
            max(bs / nbs * self.init_lr * self.min_lr_ratio, lr_limit_min * 1e-2),
            lr_limit_max * 1e-2,
        )
        return init_lr_fit, min_lr_fit
