"""The training cells' dataset: synthetic RGB + NIR pairs written as PNG
files with their annotation lines, drawn from the run's seed.

A frozen copy of the port's `tools/make_synth_dataset.py` generator (bright
ellipse "tomato bunches" on a dark background, 1-4 a pair; NIR the RGB's
channels shuffled, scaled and noised), seeded by the run instead of its
fixed PCG64(7), its noise drawn in float32.  The lines are the VOC annotation format the training CLI
reads: `rgb_path nir_path x1,y1,x2,y2,class ...`.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image


def _fill_ellipse(img: np.ndarray, box: Tuple[int, int, int, int], color) -> None:
    x1, y1, x2, y2 = box
    cx, cy = (x1 + x2 + 1) / 2.0, (y1 + y2 + 1) / 2.0
    rx, ry = (x2 - x1 + 1) / 2.0, (y2 - y1 + 1) / 2.0
    ys, xs = np.ogrid[y1:y2 + 1, x1:x2 + 1]
    inside = ((xs + 0.5 - cx) / rx) ** 2 + ((ys + 0.5 - cy) / ry) ** 2 <= 1.0
    img[y1:y2 + 1, x1:x2 + 1][inside] = color


def write_dataset(out_dir: str, n: int, hw: Tuple[int, int], seed: int,
                  boxes: Sequence[int] = (1, 4)) -> List[str]:
    """Write n pairs of size hw (H, W) under out_dir; return the
    annotation lines."""
    rng = np.random.Generator(np.random.PCG64(seed))
    h, w = hw
    # the generator's box sizes, scaled down with the image where it is small
    bw_lo, bw_hi = min(40, w // 4), min(120, w // 2)
    bh_lo, bh_hi = min(40, h // 4), min(100, h // 2)
    lines, pending = [], []
    for i in range(n):
        bg = rng.integers(10, 60)
        img = np.empty((h, w, 3), np.uint8)
        img[:] = (int(bg), int(bg * 1.2), int(bg))
        objs = []
        for _ in range(int(rng.integers(boxes[0], boxes[1] + 1))):
            bw, bh = int(rng.integers(bw_lo, bw_hi)), int(rng.integers(bh_lo, bh_hi))
            x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            color = (int(rng.integers(180, 255)), int(rng.integers(30, 90)),
                     int(rng.integers(30, 90)))
            _fill_ellipse(img, (x1, y1, x1 + bw, y1 + bh), color)
            objs.append((x1, y1, x1 + bw, y1 + bh))
        arr = img.astype(np.float32)
        noise = rng.standard_normal((2, *arr.shape), dtype=np.float32)
        rgb = np.clip(arr + 8.0 * noise[0], 0, 255).astype(np.uint8)
        nir = np.clip(arr[..., [2, 0, 1]] * 0.9 + 10.0 * noise[1], 0, 255).astype(np.uint8)
        paths = [os.path.join(out_dir, f"{i:06d}_{tag}.png") for tag in ("rgb", "nir")]
        pending += [(paths[0], rgb), (paths[1], nir)]
        lines.append(" ".join(paths + [f"{a},{b},{c},{d},0" for a, b, c, d in objs]))
    # noisy pixels do not compress: stored PNGs, written by a few threads
    with ThreadPoolExecutor(4) as pool:
        for f in [pool.submit(_save, p, a) for p, a in pending]:
            f.result()
    return lines


def _save(path: str, arr: np.ndarray) -> None:
    Image.fromarray(arr).save(path, compress_level=0)
