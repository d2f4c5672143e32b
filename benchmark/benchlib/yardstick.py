"""The yardstick: the H100's peaks, the roofline bound, the bytes and
operations each hand-written kernel's work needs, and the FLOPs of a
forward (and backward) pass.

The peaks are NVIDIA's H100 SXM data sheet at its 700 W limit, dense
rates.  A kernel's bound is the larger of its bytes over the HBM rate and
its operations over the peak of its type; each input byte is counted
read once and each output byte written once.  The counts are frozen copies
of `chip_smoke.py`'s (kernels A, B, C); B's operations are the IoU pairs
the greedy pass over the candidates needs, counted by `nms_pairs`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from reference.model import ReferenceYolo, Sizes

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
STEM_CO = 16


def bound_s(nbytes: float, ops: float, peak: float) -> float:
    """Least seconds for work that moves nbytes and does ops at peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def stem_eval_work(batch: int, input_hw: Tuple[int, int]) -> Tuple[float, float]:
    """Kernel A, one launch (one modality): bytes and FLOPs.  Reads the
    bf16 (B, 3, H+2, W+2) canvas, the bf16 (16, 3, 3, 3) folded weights and
    the float32 bias; writes the bf16 (B, H/2, W/2, 16) map."""
    h, w = input_hw
    nbytes = (batch * 3 * (h + 2) * (w + 2) * 2 + batch * (h // 2) * (w // 2) * STEM_CO * 2
              + STEM_CO * 27 * 2 + STEM_CO * 4)
    return float(nbytes), float(2 * batch * h * w * STEM_CO * 27)


def stem_train_work(batch: int, input_hw: Tuple[int, int], elem: int = 2
                    ) -> Tuple[float, float]:
    """Kernel C, one launch (one modality): the NHWC input, the max and
    min pools, the weights and the (16, 2) float32 sums."""
    h, w = input_hw
    nbytes = (batch * h * w * 3 * elem + 2 * batch * (h // 2) * (w // 2) * STEM_CO * elem
              + STEM_CO * 27 * elem + 2 * STEM_CO * 4)
    return float(nbytes), float(2 * batch * h * w * STEM_CO * 27)


def nms_work(batch: int, k: int, pairs: int) -> Tuple[float, float]:
    """Kernel B, one call (mask and scan): 16 bytes of box, 1 of alive and
    1 of keep a candidate; 12 float32 operations an IoU pair."""
    return float(batch * k * 18), float(12 * pairs)


def nms_pairs(boxes: np.ndarray, alive: np.ndarray, thr: float) -> int:
    """IoU evaluations the greedy pass needs over one image's score-sorted
    candidates (K, 4) xyxy: each kept candidate against every later one
    still alive at its turn."""
    a = alive.copy()
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    n = int(np.nonzero(a)[0].max()) + 1 if a.any() else 0
    pairs = 0
    for i in range(n):
        if not a[i]:
            continue
        later = np.nonzero(a[i + 1:n])[0] + i + 1
        pairs += len(later)
        iw = np.clip(np.minimum(boxes[later, 2], boxes[i, 2])
                     - np.maximum(boxes[later, 0], boxes[i, 0]), 0, None)
        ih = np.clip(np.minimum(boxes[later, 3], boxes[i, 3])
                     - np.maximum(boxes[later, 1], boxes[i, 1]), 0, None)
        inter = iw * ih
        den = area[later] + area[i] - inter + np.float32(1e-7)
        a[later[inter / den > np.float32(thr)]] = False
    return pairs


def candidate_pairs(boxes: torch.Tensor, scores: torch.Tensor, conf: float,
                    k: int, thr: float) -> int:
    """`nms_pairs` over one image's top-k candidates at or above conf,
    from per-anchor (A, 4) boxes and (A,) scores of one class."""
    s = scores.float().cpu().numpy()
    order = np.argsort(-s, kind="stable")[:k]
    alive = s[order] >= conf
    return nms_pairs(boxes.float().cpu().numpy()[order], alive, thr)


def forward_flops(sizes: Sizes, batch: int, train: bool = False) -> int:
    """FLOPs of one forward (train=False, eval) or one forward and backward
    (train=True, train mode) of the plain-stem network of `sizes` at its
    input shape, counted by `torch.utils.flop_counter` on the meta device:
    convolutions and matrix products at 2 FLOPs a multiply-add,
    elementwise work not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = ReferenceYolo(sizes)
    h, w = sizes.input_hw
    x = torch.zeros(batch, h, w, 3, device="meta")
    model.train(train)
    with FlopCounterMode(display=False) as counter:
        if train:
            feats = model.train_feats(x, x)
            sum(f.sum() for f in feats).backward()
        else:
            with torch.no_grad():
                model(x, x)
    return int(counter.get_total_flops())
