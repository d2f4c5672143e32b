"""Model configuration: the port's own copy of `dcfa_yolo_tpu/config.py`'s
`ModelConfig` and phi tables (`nets/yolo_mul.py:328-395` of the reference).

Only the fields the serving path reads are kept; the training knobs
(`remat`, the train-stem backend) arrive with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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
