"""Learning-rate schedules (`dcfa_yolo_tpu/train/schedule.py`, reference
`get_lr_scheduler`, `nets/yolo_training.py:500-536`), pure Python.

As in the reference, the LR is a function of the epoch index, set once per
epoch (`set_optimizer_lr`, `nets/yolo_training.py:538-541`).
"""

from __future__ import annotations

import math
from typing import Callable


def get_lr_scheduler(
    lr_decay_type: str,
    lr: float,
    min_lr: float,
    total_iters: int,
    warmup_iters_ratio: float = 0.05,
    warmup_lr_ratio: float = 0.1,
    no_aug_iter_ratio: float = 0.05,
    step_num: int = 10,
) -> Callable[[float], float]:
    if lr_decay_type == "cos":
        warmup_total_iters = min(max(warmup_iters_ratio * total_iters, 1), 3)
        warmup_lr_start = max(warmup_lr_ratio * lr, 1e-6)
        no_aug_iter = min(max(no_aug_iter_ratio * total_iters, 1), 15)

        def fn(iters: float) -> float:
            if iters <= warmup_total_iters:
                return ((lr - warmup_lr_start)
                        * (iters / float(warmup_total_iters)) ** 2 + warmup_lr_start)
            if iters >= total_iters - no_aug_iter:
                return min_lr
            return min_lr + 0.5 * (lr - min_lr) * (
                1.0 + math.cos(math.pi * (iters - warmup_total_iters)
                               / (total_iters - warmup_total_iters - no_aug_iter)))

        return fn

    decay_rate = (min_lr / lr) ** (1 / (step_num - 1))
    step_size = total_iters / step_num

    def step_fn(iters: float) -> float:
        if step_size < 1:
            raise ValueError("step_size must above 1.")
        return lr * decay_rate ** (iters // step_size)

    return step_fn
