"""The decay ramp of the exponential moving average of the model state
(`dcfa_yolo_tpu/train/ema.py`; the reference's EMA,
`nets/yolo_training.py:448-478`), which the flat EMA (`train/flat_opt.py::
FlatEMA`) applies to every floating entry of the state: the parameters and
the BatchNorm running statistics.
"""

from __future__ import annotations

import numpy as np


def ema_decay(updates: int, decay: float, tau: float):
    """(d(u), 1 − d(u)) in float32 arithmetic (`ema.py:31-34`)."""
    f32 = np.float32
    d = f32(decay) * (f32(1.0) - np.exp(-f32(updates) / f32(tau)))
    return float(d), float(f32(1.0) - d)
