"""Paired-modality augmentation on the host (numpy, PIL and cv2), feeding
device batches: the port's counterpart of `dcfa_yolo_tpu/data/augment.py`,
itself the counterpart of `utils/dataloader_mul.py:86-379`:
  * val path: joint BICUBIC letterbox with gray(128) padding;
  * train path: joint aspect jitter (0.7-1.3), scale (0.25-2), random
    placement, 50% horizontal flip, the same geometry for RGB and NIR;
  * mosaic: 4-pair quadrant paste around a random cut point, then joint HSV
    jitter with the same random gains on both modalities;
  * mixup: 0.5/0.5 blend, box union.

Decode, resize and paste go through PIL and the HSV jitter through cv2, as
in the JAX package, so the pixels are the JAX package's.  Every random
draw goes through the `np.random.RandomState` the caller passes (`rng`),
where the JAX package draws from the global `np.random`, in the same order:
a generator seeded like its global stream gives the same geometry and the
same boxes.  (The dataset's `random.sample` draws go through a
`random.Random`, `data/loader.py`.)
"""

from __future__ import annotations

import collections
import os
import threading
from typing import List, Sequence, Tuple

import cv2
import numpy as np
from PIL import Image


def _rand(rng: np.random.RandomState, a: float = 0.0, b: float = 1.0) -> float:
    return rng.rand() * (b - a) + a


def _paste(img: Image.Image, canvas_wh: Tuple[int, int], dx: int, dy: int) -> np.ndarray:
    """`img` pasted at (dx, dy) onto a gray(128) canvas → uint8 HWC."""
    canvas = Image.new("RGB", canvas_wh, (128, 128, 128))
    canvas.paste(img, (dx, dy))
    return np.asarray(canvas)


def _resize_paste(img: Image.Image, resized_wh: Tuple[int, int],
                  canvas_wh: Tuple[int, int], dx: int, dy: int) -> np.ndarray:
    """Bicubic resize + clipped paste onto a gray(128) canvas → uint8 HWC."""
    return _paste(img.resize(resized_wh, Image.BICUBIC), canvas_wh, dx, dy)


# Decoded-image LRU cache, bounded by bytes and shared by the loader's
# threads (`augment.py:60-94` of the JAX package): mosaic + mixup decode
# about ten images per emitted item.
_CACHE_BYTES = int(float(os.environ.get("DCFA_IMAGE_CACHE_MB", "2048")) * 1e6)
_cache: "collections.OrderedDict[str, np.ndarray]" = collections.OrderedDict()
_cache_lock = threading.Lock()
_cache_size = 0


def load_rgb_u8(path: str, cache: bool = True) -> np.ndarray:
    """Decode `path` to RGB uint8 (H, W, 3) through PIL, via the LRU cache
    unless `cache=False`.  A cached array is shared: callers do not write
    to it."""
    global _cache_size
    if cache:
        with _cache_lock:
            arr = _cache.get(path)
            if arr is not None:
                _cache.move_to_end(path)
                return arr
    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    arr = np.array(img, np.uint8)  # writable, as torch.from_numpy wants
    if cache and _CACHE_BYTES > 0:
        with _cache_lock:
            if path not in _cache:
                while _cache and _cache_size + arr.nbytes > _CACHE_BYTES:
                    _, old = _cache.popitem(last=False)
                    _cache_size -= old.nbytes
                if arr.nbytes <= _CACHE_BYTES:
                    _cache[path] = arr
                    _cache_size += arr.nbytes
    return arr


def _open_pair(line: str) -> Tuple[Image.Image, Image.Image, np.ndarray]:
    parts = line.split()
    boxes = np.array([list(map(int, b.split(","))) for b in parts[2:]],
                     dtype=np.float64).reshape(-1, 5)
    return (Image.fromarray(load_rgb_u8(parts[0])), Image.fromarray(load_rgb_u8(parts[1])),
            boxes)


def _clip_filter_boxes(boxes: np.ndarray, w: int, h: int) -> np.ndarray:
    if len(boxes) == 0:
        return boxes
    boxes[:, 0:2] = np.maximum(boxes[:, 0:2], 0)
    boxes[:, 2] = np.minimum(boxes[:, 2], w)
    boxes[:, 3] = np.minimum(boxes[:, 3], h)
    keep = (boxes[:, 2] - boxes[:, 0] > 1) & (boxes[:, 3] - boxes[:, 1] > 1)
    return boxes[keep]


def load_pair_letterbox(line: str, input_hw: Tuple[int, int],
                        rng: np.random.RandomState
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic val-path load (`utils/dataloader_mul.py:101-131`); only
    the box order is drawn."""
    rgb, nir, boxes = _open_pair(line)
    h, w = input_hw
    iw, ih = rgb.size
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    dx, dy = (w - nw) // 2, (h - nh) // 2
    out_rgb = _resize_paste(rgb, (nw, nh), (w, h), dx, dy)
    out_nir = _resize_paste(nir, (nw, nh), (w, h), dx, dy)
    if len(boxes):
        rng.shuffle(boxes)
        boxes[:, [0, 2]] = boxes[:, [0, 2]] * nw / iw + dx
        boxes[:, [1, 3]] = boxes[:, [1, 3]] * nh / ih + dy
        boxes = _clip_filter_boxes(boxes, w, h)
    return out_rgb, out_nir, boxes


def load_pair_random(line: str, input_hw: Tuple[int, int],
                     rng: np.random.RandomState, jitter: float = 0.3
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Train-path joint geometric augmentation (`utils/dataloader_mul.py:136-189`)."""
    rgb, nir, boxes = _open_pair(line)
    h, w = input_hw
    iw, ih = rgb.size

    new_ar = iw / ih * _rand(rng, 1 - jitter, 1 + jitter) / _rand(rng, 1 - jitter, 1 + jitter)
    scale = _rand(rng, 0.25, 2)
    if new_ar < 1:
        nh = int(scale * h)
        nw = int(nh * new_ar)
    else:
        nw = int(scale * w)
        nh = int(nw / new_ar)
    dx = int(_rand(rng, 0, w - nw))
    dy = int(_rand(rng, 0, h - nh))

    out_rgb = _resize_paste(rgb, (nw, nh), (w, h), dx, dy)
    out_nir = _resize_paste(nir, (nw, nh), (w, h), dx, dy)
    flip = _rand(rng) < 0.5
    if flip:
        out_rgb = np.fliplr(out_rgb)
        out_nir = np.fliplr(out_nir)

    if len(boxes):
        rng.shuffle(boxes)
        boxes[:, [0, 2]] = boxes[:, [0, 2]] * nw / iw + dx
        boxes[:, [1, 3]] = boxes[:, [1, 3]] * nh / ih + dy
        if flip:
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        boxes = _clip_filter_boxes(boxes, w, h)
    return out_rgb, out_nir, boxes


def _merge_mosaic_boxes(per_tile_boxes: Sequence[np.ndarray], cutx: int, cuty: int
                        ) -> np.ndarray:
    """Clip each quadrant's boxes to its region of the mosaic
    (`merge_bboxes`, utils/dataloader_mul.py:194-238).  Tile order: 0=TL, 1=BL,
    2=BR, 3=TR (the reference's paste order)."""
    out: List[np.ndarray] = []
    for i, boxes in enumerate(per_tile_boxes):
        for box in boxes:
            x1, y1, x2, y2, cls = box
            if i == 0:  # top-left: keep boxes overlapping [0,cutx)x[0,cuty)
                if y1 > cuty or x1 > cutx:
                    continue
                y2 = min(y2, cuty) if y2 >= cuty >= y1 else y2
                x2 = min(x2, cutx) if x2 >= cutx >= x1 else x2
            elif i == 1:  # bottom-left
                if y2 < cuty or x1 > cutx:
                    continue
                y1 = max(y1, cuty) if y2 >= cuty >= y1 else y1
                x2 = min(x2, cutx) if x2 >= cutx >= x1 else x2
            elif i == 2:  # bottom-right
                if y2 < cuty or x2 < cutx:
                    continue
                y1 = max(y1, cuty) if y2 >= cuty >= y1 else y1
                x1 = max(x1, cutx) if x2 >= cutx >= x1 else x1
            else:  # top-right
                if y1 > cuty or x2 < cutx:
                    continue
                y2 = min(y2, cuty) if y2 >= cuty >= y1 else y2
                x1 = max(x1, cutx) if x2 >= cutx >= x1 else x1
            out.append(np.array([x1, y1, x2, y2, cls]))
    return np.array(out).reshape(-1, 5)


def _hsv_jitter_pair(rgb: np.ndarray, nir: np.ndarray, hue: float, sat: float,
                     val: float, rng: np.random.RandomState
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Joint HSV colour jitter via LUTs in cv2, the same gains on both
    modalities (`utils/dataloader_mul.py:340-363`)."""
    r = rng.uniform(-1, 1, 3) * [hue, sat, val] + 1
    x = np.arange(0, 256, dtype=np.uint8)
    lut_hue = ((x * r[0]) % 180).astype(np.uint8)
    lut_sat = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_val = np.clip(x * r[2], 0, 255).astype(np.uint8)

    def apply(img):
        hch, sch, vch = cv2.split(cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
        merged = cv2.merge((cv2.LUT(hch, lut_hue), cv2.LUT(sch, lut_sat),
                            cv2.LUT(vch, lut_val)))
        return cv2.cvtColor(merged, cv2.COLOR_HSV2RGB)

    return apply(rgb), apply(nir)


def load_mosaic(lines: Sequence[str], input_hw: Tuple[int, int],
                rng: np.random.RandomState, jitter: float = 0.3, hue: float = 0.1,
                sat: float = 0.7, val: float = 0.4
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """4-pair mosaic (`utils/dataloader_mul.py:240-368`)."""
    h, w = input_hw
    min_offset_x = _rand(rng, 0.3, 0.7)
    min_offset_y = _rand(rng, 0.3, 0.7)
    tiles_rgb, tiles_nir, tile_boxes = [], [], []

    for index, line in enumerate(lines):
        rgb, nir, boxes = _open_pair(line)
        iw, ih = rgb.size

        flip = _rand(rng) < 0.5
        if flip and len(boxes) > 0:
            rgb = rgb.transpose(Image.FLIP_LEFT_RIGHT)
            nir = nir.transpose(Image.FLIP_LEFT_RIGHT)
            boxes[:, [0, 2]] = iw - boxes[:, [2, 0]]

        new_ar = iw / ih * _rand(rng, 1 - jitter, 1 + jitter) / _rand(rng, 1 - jitter, 1 + jitter)
        scale = _rand(rng, 0.4, 1)
        if new_ar < 1:
            nh = int(scale * h)
            nw = int(nh * new_ar)
        else:
            nw = int(scale * w)
            nh = int(nw / new_ar)
        rgb = rgb.resize((nw, nh), Image.BICUBIC)
        nir = nir.resize((nw, nh), Image.BICUBIC)

        if index == 0:
            dx, dy = int(w * min_offset_x) - nw, int(h * min_offset_y) - nh
        elif index == 1:
            dx, dy = int(w * min_offset_x) - nw, int(h * min_offset_y)
        elif index == 2:
            dx, dy = int(w * min_offset_x), int(h * min_offset_y)
        else:
            dx, dy = int(w * min_offset_x), int(h * min_offset_y) - nh

        tiles_rgb.append(_paste(rgb, (w, h), dx, dy))
        tiles_nir.append(_paste(nir, (w, h), dx, dy))

        if len(boxes):
            rng.shuffle(boxes)
            boxes[:, [0, 2]] = boxes[:, [0, 2]] * nw / iw + dx
            boxes[:, [1, 3]] = boxes[:, [1, 3]] * nh / ih + dy
            boxes = _clip_filter_boxes(boxes, w, h)
        tile_boxes.append(boxes)

    cutx, cuty = int(w * min_offset_x), int(h * min_offset_y)

    def stitch(tiles):
        out = np.zeros((h, w, 3), np.uint8)
        out[:cuty, :cutx] = tiles[0][:cuty, :cutx]
        out[cuty:, :cutx] = tiles[1][cuty:, :cutx]
        out[cuty:, cutx:] = tiles[2][cuty:, cutx:]
        out[:cuty, cutx:] = tiles[3][:cuty, cutx:]
        return out

    mosaic_rgb, mosaic_nir = _hsv_jitter_pair(stitch(tiles_rgb), stitch(tiles_nir),
                                              hue, sat, val, rng)
    return mosaic_rgb, mosaic_nir, _merge_mosaic_boxes(tile_boxes, cutx, cuty)


def mixup_pairs(rgb1, nir1, boxes1, rgb2, nir2, boxes2):
    """0.5/0.5 blend + box union (`utils/dataloader_mul.py:370-379`)."""
    rgb = np.asarray(rgb1, np.float32) * 0.5 + np.asarray(rgb2, np.float32) * 0.5
    nir = np.asarray(nir1, np.float32) * 0.5 + np.asarray(nir2, np.float32) * 0.5
    if len(boxes1) == 0:
        boxes = boxes2
    elif len(boxes2) == 0:
        boxes = boxes1
    else:
        boxes = np.concatenate([boxes1, boxes2], axis=0)
    return rgb, nir, boxes

