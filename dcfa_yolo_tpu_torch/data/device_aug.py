"""Augmentation on the card from a dataset staged in device memory: the
port's counterpart of `dcfa_yolo_tpu/data/device_aug.py` (reference host
pipeline `utils/dataloader_mul.py:86-379`).

The decoded dataset is staged once into device memory (uint8, about 2.5 MB
a RGB+NIR pair at 640²), and everything after the decode runs on the card:
a step sends the tile indices and a few geometry scalars (a few KB), not a
float32 batch.  Each slot's resize and paste is two batched contractions
against per-slot weight matrices, with the horizontal flips and the
mosaic's quadrant masks folded into the weights (`make_device_augment`);
the JAX package computes them in XLA, here they are `torch.bmm`.

Semantics, as the JAX module's:
  * the parameters are drawn on the host by `ParamSampler`, a copy of the
    JAX sampler: the same draws from the same `np.random.Generator` give
    the same `GeomParams`, reference int truncations included
    (`int(scale*h)`, the flip-only-when-boxes-exist mosaic rule of
    `dataloader_mul.py:247-251`);
  * the mosaic's quadrant paste and `merge_bboxes` clipping
    (`dataloader_mul.py:194-238`), without its re-filter of degenerate
    boxes (a reference quirk);
  * the joint HSV gains on both modalities (`:340-363`) and 0.5/0.5 mixup
    (`:370-379`);
  * tiles are staged at one resolution and resampled on the card with the
    antialiased Keys cubic kernel (`jax.image.scale_and_translate`'s), not
    PIL's one-step BICUBIC from the original; box arithmetic is exact;
  * the `max_boxes` largest-area boxes are kept, ties to the lower slot
    (`lax.top_k`'s order: a stable descending sort, since `torch.topk`
    orders ties otherwise).

`resample_dtype=torch.bfloat16` multiplies bf16 operands (the tiles and
the weight matrices, computed in float32 then rounded) into float32
results, rounds the first contraction's result to bf16 and keeps the
second in float32, as the JAX program's `preferred_element_type=f32`
does; box geometry stays float32.  float32 resampling runs with TF32 off
(the JAX program's `precision="highest"`).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from dcfa_yolo_tpu_torch.data.augment import load_rgb_u8
from dcfa_yolo_tpu_torch.data.batch import Batch
from dcfa_yolo_tpu_torch.device import resolve_device
from dcfa_yolo_tpu_torch.utils.profiling import span


class StagedDataset(NamedTuple):
    """Host-side staged arrays (uint8 tiles + normalized boxes)."""

    images: np.ndarray    # (N, 2, Sh, Sw, 3) uint8 -- [rgb, nir]
    boxes: np.ndarray     # (N, T, 5) float32, xyxy normalized to [0,1] + cls
    nbox: np.ndarray      # (N,) int32 valid box count
    orig_wh: np.ndarray   # (N, 2) float32 original (iw, ih)
    overflow_items: int = 0    # items whose gt count exceeded max_boxes
    overflow_dropped: int = 0  # boxes dropped by the largest-area cap


class GeomParams(NamedTuple):
    """Per-sample augmentation parameters, all host-computed (B-leading).

    Slots 0-3 are the mosaic quadrant tiles (paste order TL,BL,BR,TR --
    `dataloader_mul.py:264-271`); slot 0 doubles as the plain-path image when
    ``mode`` is 0; slot 4 is the mixup partner (always plain-jittered,
    `dataloader_mul.py:370`).
    """

    idx: np.ndarray        # (B, 5) int32 dataset indices per slot
    mode: np.ndarray       # (B,) f32: 1 = mosaic, 0 = plain/letterbox
    mix: np.ndarray        # (B,) f32: 1 = blend slot4 in
    preflip: np.ndarray    # (B, 5) f32 flip source before resize (mosaic tiles)
    postflip: np.ndarray   # (B, 5) f32 flip the composited canvas (plain path)
    nw: np.ndarray         # (B, 5) f32 resized width (reference int truncation)
    nh: np.ndarray         # (B, 5) f32 resized height
    dx: np.ndarray         # (B, 5) f32 paste x offset (may be negative)
    dy: np.ndarray         # (B, 5) f32 paste y offset
    cut: np.ndarray        # (B, 2) f32 (cutx, cuty) mosaic stitch point
    hsv: np.ndarray        # (B, 3) f32 HSV gains r (1.0 = identity)


# ---------------------------------------------------------------------------
# Staging (host, one-time)
# ---------------------------------------------------------------------------

def stage_pairs(lines: Sequence[str], stage_hw: Tuple[int, int],
                max_boxes: int = 64) -> StagedDataset:
    """Decode + stretch-resize every pair once to a fixed staging resolution.

    Boxes are stored normalized to the ORIGINAL image size, so the staging
    stretch is transparent to all downstream box math.  Items with more than
    ``max_boxes`` ground truths keep the largest-area ones (the host
    BatchLoader's overflow policy).
    """
    sh, sw = stage_hw
    n = len(lines)
    images = np.empty((n, 2, sh, sw, 3), np.uint8)
    boxes = np.zeros((n, max_boxes, 5), np.float32)
    nbox = np.zeros((n,), np.int32)
    overflow_items = 0
    overflow_dropped = 0
    orig_wh = np.zeros((n, 2), np.float32)
    for i, line in enumerate(lines):
        parts = line.split()
        # cache=False: staging is one-shot; the host LRU would pin GBs of
        # decoded images that nothing reads again
        rgb = load_rgb_u8(parts[0], cache=False)
        nir = load_rgb_u8(parts[1], cache=False)
        ih, iw = rgb.shape[:2]
        orig_wh[i] = (iw, ih)
        for m, arr in enumerate((rgb, nir)):
            if arr.shape[:2] != (sh, sw):
                arr = np.asarray(
                    Image.fromarray(arr).resize((sw, sh), Image.BICUBIC))
            images[i, m] = arr
        b = np.array([list(map(int, s.split(","))) for s in parts[2:]],
                     np.float32).reshape(-1, 5)
        if len(b) > max_boxes:
            area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
            overflow_items += 1
            overflow_dropped += len(b) - max_boxes
            b = b[np.argsort(-area)[:max_boxes]]
        if len(b):
            b[:, [0, 2]] /= iw
            b[:, [1, 3]] /= ih
            boxes[i, : len(b)] = b
        nbox[i] = len(b)
    return StagedDataset(images, boxes, nbox, orig_wh,
                         overflow_items, overflow_dropped)


# ---------------------------------------------------------------------------
# Host parameter sampling (reference distributions + int math, exactly)
# ---------------------------------------------------------------------------

class ParamSampler:
    """Draws reference-distributed augmentation parameters on the host.

    Mirrors `utils/dataloader_mul.py`: mosaic tile geometry (:253-271), plain
    jitter (:136-158), HSV gains (:340-346), mosaic/mixup gating
    (`YoloDataset.__getitem__`, :32-54).  Keeping the draw on the host keeps
    every int() truncation bit-identical to the reference; the device program
    consumes the results as data.
    """

    def __init__(self, ds: StagedDataset, input_hw: Tuple[int, int], *,
                 train: bool = True, mosaic: bool = True,
                 mosaic_prob: float = 0.5, mixup: bool = True,
                 mixup_prob: float = 0.5, special_aug_ratio: float = 0.7,
                 epoch_length: int = 200, jitter: float = 0.3,
                 hue: float = 0.1, sat: float = 0.7, val: float = 0.4):
        self.ds = ds
        self.h, self.w = input_hw
        self.train = train
        self.mosaic = mosaic and train
        self.mosaic_prob = mosaic_prob
        self.mixup = mixup and train
        self.mixup_prob = mixup_prob
        self.special_aug_ratio = special_aug_ratio
        self.epoch_length = epoch_length
        self.jitter = jitter
        self.hue, self.sat, self.val = hue, sat, val
        self.epoch_now = -1

    def set_epoch(self, epoch: int) -> None:
        self.epoch_now = epoch

    # -- reference `self.rand()` (`dataloader_mul.py:28-29`)
    @staticmethod
    def _rand(rng, a=0.0, b=1.0):
        return float(rng.random()) * (b - a) + a

    def _jitter_geom(self, rng, iw, ih, scale_lo, scale_hi):
        """Shared aspect+scale draw (`dataloader_mul.py:140-147, 253-260`)."""
        j = self.jitter
        new_ar = (iw / ih * self._rand(rng, 1 - j, 1 + j)
                  / self._rand(rng, 1 - j, 1 + j))
        scale = self._rand(rng, scale_lo, scale_hi)
        if new_ar < 1:
            nh = int(scale * self.h)
            nw = int(nh * new_ar)
        else:
            nw = int(scale * self.w)
            nh = int(nw / new_ar)
        # the reference would crash in PIL on a 0-size resize; clamp instead
        return max(nw, 1), max(nh, 1)

    def _orig_wh(self, img_idx):
        # Python floats (f64): the reference does this arithmetic in double,
        # and float32 products can flip an int() truncation by one pixel
        iw, ih = self.ds.orig_wh[img_idx]
        return float(iw), float(ih)

    def _plain_slot(self, rng, img_idx):
        """load_pair_random geometry (`dataloader_mul.py:136-158`): jitter +
        scale(.25,2) + random placement; flip applied to the composited canvas."""
        iw, ih = self._orig_wh(img_idx)
        nw, nh = self._jitter_geom(rng, iw, ih, 0.25, 2.0)
        dx = int(self._rand(rng, 0, self.w - nw))
        dy = int(self._rand(rng, 0, self.h - nh))
        flip = self._rand(rng) < 0.5
        return nw, nh, dx, dy, flip

    def sample(self, rng: np.random.Generator, indices: np.ndarray
               ) -> GeomParams:
        """Draw parameters for one batch whose primary images are ``indices``."""
        b = len(indices)
        n_img = len(self.ds.images)
        p = GeomParams(
            idx=np.zeros((b, 5), np.int32),
            mode=np.zeros((b,), np.float32),
            mix=np.zeros((b,), np.float32),
            preflip=np.zeros((b, 5), np.float32),
            postflip=np.zeros((b, 5), np.float32),
            nw=np.ones((b, 5), np.float32),
            nh=np.ones((b, 5), np.float32),
            dx=np.full((b, 5), -4.0, np.float32),
            dy=np.full((b, 5), -4.0, np.float32),
            cut=np.zeros((b, 2), np.float32),
            hsv=np.ones((b, 3), np.float32),
        )
        for k, index in enumerate(indices):
            p.idx[k, :] = index
            if not self.train:
                # deterministic val letterbox (`dataloader_mul.py:101-131`)
                iw, ih = self._orig_wh(index)
                scale = min(self.w / iw, self.h / ih)
                nw, nh = int(iw * scale), int(ih * scale)
                p.nw[k, 0], p.nh[k, 0] = nw, nh
                p.dx[k, 0] = (self.w - nw) // 2
                p.dy[k, 0] = (self.h - nh) // 2
                continue
            use_mosaic = (
                self.mosaic and rng.random() < self.mosaic_prob
                and self.epoch_now < self.epoch_length * self.special_aug_ratio)
            if use_mosaic:
                p.mode[k] = 1.0
                # 3 random partners + self, shuffled (`dataloader_mul.py:43-45`)
                others = rng.choice(n_img, size=min(3, n_img), replace=False)
                tile_idx = np.concatenate([others, [index]])
                rng.shuffle(tile_idx)
                if len(tile_idx) < 4:  # degenerate tiny dataset
                    tile_idx = np.resize(tile_idx, 4)
                p.idx[k, :4] = tile_idx
                mox = self._rand(rng, 0.3, 0.7)
                moy = self._rand(rng, 0.3, 0.7)
                p.cut[k] = (int(self.w * mox), int(self.h * moy))
                for s in range(4):
                    ii = int(tile_idx[s])
                    iw, ih = self._orig_wh(ii)
                    flip = self._rand(rng) < 0.5
                    # flip is a no-op for box-less tiles (`:247-251` quirk)
                    p.preflip[k, s] = float(flip and self.ds.nbox[ii] > 0)
                    nw, nh = self._jitter_geom(rng, iw, ih, 0.4, 1.0)
                    p.nw[k, s], p.nh[k, s] = nw, nh
                    if s == 0:    # TL
                        dx, dy = int(self.w * mox) - nw, int(self.h * moy) - nh
                    elif s == 1:  # BL
                        dx, dy = int(self.w * mox) - nw, int(self.h * moy)
                    elif s == 2:  # BR
                        dx, dy = int(self.w * mox), int(self.h * moy)
                    else:         # TR
                        dx, dy = int(self.w * mox), int(self.h * moy) - nh
                    p.dx[k, s], p.dy[k, s] = dx, dy
                # joint HSV gains (`:340-346`)
                r = (rng.uniform(-1, 1, 3)
                     * np.array([self.hue, self.sat, self.val]) + 1)
                p.hsv[k] = r
                if self.mixup and rng.random() < self.mixup_prob:
                    p.mix[k] = 1.0
                    mi = int(rng.integers(n_img))
                    p.idx[k, 4] = mi
                    nw, nh, dx, dy, flip = self._plain_slot(rng, mi)
                    p.nw[k, 4], p.nh[k, 4] = nw, nh
                    p.dx[k, 4], p.dy[k, 4] = dx, dy
                    p.postflip[k, 4] = float(flip)
            else:
                nw, nh, dx, dy, flip = self._plain_slot(rng, index)
                p.nw[k, 0], p.nh[k, 0] = nw, nh
                p.dx[k, 0], p.dy[k, 0] = dx, dy
                p.postflip[k, 0] = float(flip)
        return p


# ---------------------------------------------------------------------------
# Device program
# ---------------------------------------------------------------------------

def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution kernel (a=-0.5), the BICUBIC kernel, as
    `jax.image.ResizeMethod.CUBIC` computes it."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _weight_matrix(in_size: int, out_size: int, n_px: torch.Tensor,
                   d_px: torch.Tensor, mirror: torch.Tensor) -> torch.Tensor:
    """(S, in_size, out_size) float32 resampling matrices, one a slot: resize
    a source axis to ``n_px`` pixels pasted at offset ``d_px`` of an
    ``out_size`` canvas, antialiased Keys cubic, output pixels outside the
    paste extent zeroed (the caller turns that zero fill into gray padding
    with a -128 shift).  n_px, d_px, mirror: (S,) float32.

    The JAX module's `_weight_matrix` (`jax.image.scale_and_translate(
    scale=n/in, translation=d, cubic, antialias=True)`) batched over slots.
    ``mirror`` folds a horizontal source flip into the weights
    (u -> in_size-1-u).
    """
    f32, dev = torch.float32, n_px.device
    # a tensor divisor: CUDA divides by a Python number as a multiply by its
    # reciprocal, one ulp off the quotient, and `sample` multiplies that by
    # the output size
    scale = n_px / torch.full_like(n_px, in_size)
    inv = 1.0 / scale
    kscale = torch.clamp_min(inv, 1.0)  # antialias: widen kernel when shrinking
    sample = ((torch.arange(out_size, dtype=f32, device=dev) + 0.5) * inv[:, None]
              - (d_px * inv)[:, None] - 0.5)                      # (S, out)
    sample_m = torch.where(mirror[:, None] > 0, (in_size - 1.0) - sample, sample)
    x = (sample_m[:, None, :] - torch.arange(in_size, dtype=f32, device=dev)[:, None]
         ).abs_().div_(kscale[:, None, None])                     # (S, in, out)
    w = _keys_cubic(x)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    valid = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(valid[:, None, :], w, 0.0)


def _rgb_to_hsv_cv(r, g, b):
    """cv2-convention HSV from float32 RGB in [0,255]: H in [0,180), S,V in
    [0,255].  Floor modulo (`torch.remainder`), as `jnp`'s `%`."""
    v = torch.maximum(torch.maximum(r, g), b)
    c = v - torch.minimum(torch.minimum(r, g), b)
    safe = torch.where(c == 0, 1.0, c)
    h = torch.where(
        v == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(v == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(c == 0, 0.0, h) * 30.0  # degrees / 2 (cv2 8-bit convention)
    s = torch.where(v == 0, 0.0, c / torch.where(v == 0, 1.0, v)) * 255.0
    return h, s, v


def _hsv_to_rgb_cv(h, s, v, dim: int):
    sv = (s / 255.0) * v

    def chan(n):
        k = torch.remainder(n + h / 30.0, 6.0)  # cv2 H is degrees/2, so /30 not /60
        return v - sv * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([chan(5.0), chan(3.0), chan(1.0)], dim=dim)


def _hsv_jitter(canvas: torch.Tensor, gains: torch.Tensor, dim: int = -1
                ) -> torch.Tensor:
    """Joint HSV jitter, same gains on both modalities
    (`dataloader_mul.py:340-363`).  Continuous-valued equivalent of the
    reference's uint8 LUTs: h*r0 mod 180, clip(s*r1), clip(v*r2).
    canvas: float32 in [0, 255] with its RGB channels on `dim`; gains: the
    three gains, broadcastable to a channel's shape."""
    r, g, b = canvas.unbind(dim)
    h, s, v = _rgb_to_hsv_cv(r, g, b)
    g0, g1, g2 = gains.unbind(-1)
    h = torch.remainder(h * g0, 180.0)
    s = torch.clamp(s * g1, 0.0, 255.0)
    v = torch.clamp(v * g2, 0.0, 255.0)
    return _hsv_to_rgb_cv(h, s, v, dim)


def _fma(a: torch.Tensor, s: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """a·s + o rounded once to float32, as XLA computes the JAX program's
    `x * nw + dx` (a fused multiply-add).  Through float64, exact here: a
    normalized coordinate times an integer size plus an integer offset
    needs far fewer than float64's 53 bits."""
    return (a.double() * s.double() + o.double()).float()


def _transform_boxes(bn, nw, nh, dx, dy, preflip, postflip, out_hw):
    """Reference box math (`dataloader_mul.py:160-166, 281-285`), vectorized:
    optional pre-resize flip (normalized), scale+offset to canvas pixels,
    optional post-composite flip, clip, and the w>1 & h>1 validity filter."""
    h, w = out_hw
    x1, y1, x2, y2, cls = bn.unbind(-1)
    # pre-flip in normalized source space: x -> 1-x (swap x1/x2)
    fx1 = torch.where(preflip > 0, 1.0 - x2, x1)
    fx2 = torch.where(preflip > 0, 1.0 - x1, x2)
    x1p, x2p, y1p, y2p = (_fma(a, s, o) for a, s, o in
                          ((fx1, nw, dx), (fx2, nw, dx), (y1, nh, dy), (y2, nh, dy)))
    # post-flip in canvas space: x -> w-x (swap)
    gx1 = torch.where(postflip > 0, w - x2p, x1p)
    gx2 = torch.where(postflip > 0, w - x1p, x2p)
    x1c = torch.clamp_min(gx1, 0.0)
    y1c = torch.clamp_min(y1p, 0.0)
    x2c = torch.clamp_max(gx2, float(w))
    y2c = torch.clamp_max(y2p, float(h))
    valid = (x2c - x1c > 1.0) & (y2c - y1c > 1.0)
    return torch.stack([x1c, y1c, x2c, y2c, cls], -1), valid


def _merge_quadrants(boxes: torch.Tensor, valid: torch.Tensor, cutx, cuty):
    """`merge_bboxes` (`dataloader_mul.py:194-238`): per-quadrant keep rule +
    clip to the cut lines.  Deliberately does NOT re-filter degenerate boxes
    afterward (reference quirk).  boxes: (..., 4, T, 5), slot order
    TL,BL,BR,TR; valid (..., 4, T); cutx, cuty broadcastable to (..., T)."""
    cutx = torch.as_tensor(cutx, dtype=boxes.dtype, device=boxes.device)
    cuty = torch.as_tensor(cuty, dtype=boxes.dtype, device=boxes.device)
    x1, y1, x2, y2 = (boxes[..., i].unbind(-2) for i in range(4))
    keep = torch.stack([
        (y1[0] <= cuty) & (x1[0] <= cutx),
        (y2[1] >= cuty) & (x1[1] <= cutx),
        (y2[2] >= cuty) & (x2[2] >= cutx),
        (y1[3] <= cuty) & (x2[3] >= cutx),
    ], -2)
    nx1 = torch.stack([x1[0], x1[1], torch.maximum(x1[2], cutx),
                       torch.maximum(x1[3], cutx)], -2)
    ny1 = torch.stack([y1[0], torch.maximum(y1[1], cuty),
                       torch.maximum(y1[2], cuty), y1[3]], -2)
    nx2 = torch.stack([torch.minimum(x2[0], cutx), torch.minimum(x2[1], cutx),
                       x2[2], x2[3]], -2)
    ny2 = torch.stack([torch.minimum(y2[0], cuty), y2[1], y2[2],
                       torch.minimum(y2[3], cuty)], -2)
    out = torch.stack([nx1, ny1, nx2, ny2, boxes[..., 4]], -1)
    return out, valid & keep


@contextlib.contextmanager
def _ieee_matmul():
    """float32 matmuls in float32 (TF32 off) for the enclosed calls."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b into float32: bf16 operands multiply exactly and sum in
    float32 (cuBLAS's bf16 GEMM with a float32 output on the card; on the
    CPU the same products in a float32 GEMM)."""
    if a.dtype == torch.bfloat16 and a.device.type == "cuda":
        return torch.bmm(a, b, torch.float32)
    return torch.bmm(a.float(), b.float())


def make_device_augment(out_hw: Tuple[int, int], max_boxes: int = 64,
                        resample_dtype: Optional[torch.dtype] = None,
                        out_dtype: Optional[torch.dtype] = None):
    """Build the augmentation program.

    Returns ``augment(images_u8, boxes_norm, nbox, idx, params) ->
    (rgb, nir, gt_boxes, gt_labels, gt_mask)``: images_u8 the staged
    (N, 2, Sh, Sw, 3) uint8 dataset, boxes_norm (N, T, 5), nbox (N,), idx
    (B, 5) and params a GeomParams, all tensors on one device (the program
    runs there).  rgb / nir (B, H, W, 3) NHWC in [0, 1] in ``out_dtype``
    (float32 by default); gt_boxes (B, max_boxes, 4) canvas pixels, labels
    and mask (B, max_boxes), float32.  The JAX program's `jax.vmap` over
    the batch is the batch dimension of every op here.

    Pixel path: each slot's resize + paste is two batched contractions
    (over the source rows, then the source columns) against the slot's
    float32 weight matrices (`_weight_matrix`).  The flips (pre- and
    post-composite) and the mosaic quadrant stitch are folded into the
    weights: a post-composite flip is the same composite with mirrored
    content at dx' = W-nw-dx, and each quadrant mask is a rank-1 product
    row_mask(h)·col_mask(w) absorbed into the two matrices, so the four
    zero-filled slot composites plus one gray offset sum to the stitched
    mosaic (or, with slots 1-3 masked out, the plain composite).
    """
    h, w = out_hw
    rdt = resample_dtype or torch.float32
    odt = out_dtype or torch.float32

    def augment(images_u8, boxes_norm, nbox, idx, p: GeomParams):
        dev = images_u8.device
        b = idx.shape[0]
        flat_idx = idx.reshape(-1).long()
        n_mod, sh, sw, ch = images_u8.shape[1:]
        n_slot = b * 5
        # tiles as (slot, modality, channel, Sw, Sh): the first contraction
        # runs over Sh with (modality, channel, Sw) as its rows
        src = torch.empty((n_slot, n_mod, ch, sw, sh), dtype=rdt, device=dev)
        src.copy_(images_u8[flat_idx].permute(0, 1, 4, 3, 2))
        src -= 128.0

        # content mirror = preflip XOR postflip; postflip also mirrors the
        # paste position (flip(composite(t)) == composite(mirror(t)) at
        # dx' = W - nw - dx)
        mirror = (p.preflip - p.postflip).abs()
        dx_eff = torch.where(p.postflip > 0, w - p.nw - p.dx, p.dx)
        wh = _weight_matrix(sh, h, p.nh.reshape(-1), p.dy.reshape(-1),
                            torch.zeros_like(mirror).reshape(-1))     # (B*5, Sh, H)
        ww = _weight_matrix(sw, w, p.nw.reshape(-1), dx_eff.reshape(-1),
                            mirror.reshape(-1))                       # (B*5, Sw, W)

        # mosaic quadrant masks (paste order TL,BL,BR,TR,
        # `dataloader_mul.py:264-271, 290-296`), separable: folded into the
        # slot weight matrices; slot 4 (the mixup partner) is never masked
        cutx, cuty = p.cut[:, 0], p.cut[:, 1]
        is_m = (p.mode > 0)[:, None, None]
        top = (torch.arange(h, dtype=torch.float32, device=dev) < cuty[:, None]).float()
        left = (torch.arange(w, dtype=torch.float32, device=dev) < cutx[:, None]).float()
        one_h, one_w = torch.ones_like(top), torch.ones_like(left)
        zero_h, zero_w = torch.zeros_like(top), torch.zeros_like(left)
        rowm = torch.where(is_m, torch.stack([top, 1 - top, 1 - top, top, one_h], 1),
                           torch.stack([one_h, zero_h, zero_h, zero_h, one_h], 1))
        colm = torch.where(is_m, torch.stack([left, left, 1 - left, 1 - left, one_w], 1),
                           torch.stack([one_w, zero_w, zero_w, zero_w, one_w], 1))
        wh = (wh * rowm.reshape(n_slot, 1, h)).to(rdt)
        ww = (ww * colm.reshape(n_slot, 1, w)).to(rdt)

        with _ieee_matmul():
            t1 = _contract(src.view(n_slot, n_mod * ch * sw, sh), wh)  # (m, c, Sw, H)
            # the first contraction's result in the resampling dtype, its
            # rows (modality, channel, H) for the second
            t1 = torch.empty((n_slot, n_mod, ch, h, sw), dtype=rdt, device=dev).copy_(
                t1.view(n_slot, n_mod, ch, sw, h).transpose(3, 4))
            res = _contract(t1.view(n_slot, n_mod * ch * h, sw), ww)
        res = res.view(b, 5, n_mod, ch, h, w)
        comp = res[:, :4].sum(1) + 128.0                               # (B, 2, 3, H, W)
        mixp = res[:, 4] + 128.0

        sel = lambda flag: flag.view(b, 1, 1, 1, 1)
        main = torch.where(sel(p.mode > 0),
                           _hsv_jitter(comp, p.hsv.view(b, 1, 1, 1, 3), dim=2), comp)
        out = torch.where(sel(p.mix > 0), 0.5 * main + 0.5 * mixp, main)
        out = torch.clamp(out, 0.0, 255.0) / 255.0   # uint8 saturation + /255
        rgb, nir = (torch.empty((b, h, w, ch), dtype=odt, device=dev).copy_(
            out[:, m].permute(0, 2, 3, 1)) for m in range(2))

        # ---- boxes ----
        tboxes = boxes_norm[flat_idx].view(b, 5, *boxes_norm.shape[1:])
        counts = nbox[flat_idx].view(b, 5)
        t = boxes_norm.shape[1]
        tvalid = torch.arange(t, device=dev) < counts[..., None]
        col = lambda v: v[..., None]
        bpx, bval = _transform_boxes(tboxes, col(p.nw), col(p.nh), col(p.dx),
                                     col(p.dy), col(p.preflip), col(p.postflip),
                                     out_hw)
        bval = bval & tvalid
        mboxes, mvalid = _merge_quadrants(bpx[:, :4], bval[:, :4], cutx[:, None],
                                          cuty[:, None])
        slot_on = torch.where(is_m, mvalid, torch.cat(
            [bval[:, :1], torch.zeros_like(bval[:, 1:4])], 1))
        coords = torch.where(is_m[..., None], mboxes, bpx[:, :4])
        all_boxes = torch.cat([coords, bpx[:, 4:5]], 1)                  # (B, 5, T, 5)
        all_valid = torch.cat([slot_on, (bval[:, 4] & (p.mix > 0)[:, None])[:, None]], 1)
        flat = all_boxes.reshape(b, -1, 5)
        fval = all_valid.reshape(b, -1)
        area = (flat[..., 2] - flat[..., 0]) * (flat[..., 3] - flat[..., 1])
        # keep the largest-area max_boxes (the overflow policy), ties in
        # slot order as `lax.top_k` keeps them
        keep = torch.sort(torch.where(fval, area, -1.0), dim=1, descending=True,
                          stable=True).indices[:, :max_boxes]
        chosen = torch.gather(flat, 1, keep[..., None].expand(-1, -1, 5))
        msk = torch.gather(fval, 1, keep).float()
        return (rgb, nir, chosen[..., :4] * msk[..., None], chosen[..., 4] * msk, msk)

    return augment


# ---------------------------------------------------------------------------
# Loader facade
# ---------------------------------------------------------------------------

class DeviceAugLoader:
    """Drop-in alternative to `data/loader.py::BatchLoader` that yields
    DEVICE batches (`data/batch.py::Batch`, images in ``out_dtype``).

    Stages the dataset into device memory once; then each batch is: the
    host draws the geometry scalars (ParamSampler), sends a few KB to the
    card, and the program gathers the tiles from the resident dataset and
    builds the augmented batch there -- no image copy a step.

    `batch_size` is the global batch: every rank stages the whole dataset,
    draws the global batch's parameters from the same stream, and augments
    its rows [rank·B/W, (rank+1)·B/W), the slice a JAX data sharding puts
    on a device.  `device`: where the dataset and the program live (the
    card unless the CPU is asked for).
    """

    def __init__(self, annotation_lines: Sequence[str],
                 input_shape: Tuple[int, int], batch_size: int, *,
                 train: bool = True, max_boxes: int = 64,
                 stage_hw: Optional[Tuple[int, int]] = None,
                 mosaic: bool = True, mosaic_prob: float = 0.5,
                 mixup: bool = True, mixup_prob: float = 0.5,
                 special_aug_ratio: float = 0.7, epoch_length: int = 200,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 11,
                 max_hbm_gb: float = 8.0, resample_dtype=None,
                 out_dtype=None, staged: Optional[StagedDataset] = None,
                 dev_data=None, device="cuda", rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f"a batch of {batch_size} does not divide over "
                             f"{world} ranks")
        lines = [l.strip() for l in annotation_lines if l.strip()]
        stage_hw = tuple(stage_hw or input_shape)
        need = len(lines) * 2 * stage_hw[0] * stage_hw[1] * 3
        if need > max_hbm_gb * 1e9:
            raise ValueError(
                f"staged dataset needs {need/1e9:.1f} GB of device memory "
                f"(> {max_hbm_gb} GB cap); lower --device-aug-stage or use "
                f"the host BatchLoader")
        self.device = resolve_device(device)
        ds = staged if staged is not None else stage_pairs(
            lines, stage_hw, max_boxes)
        self.host_ds = ds
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.rank, self.world = rank, world
        self.sampler = ParamSampler(
            ds, input_shape, train=train, mosaic=mosaic,
            mosaic_prob=mosaic_prob, mixup=mixup, mixup_prob=mixup_prob,
            special_aug_ratio=special_aug_ratio, epoch_length=epoch_length)
        if dev_data is not None:
            # share the resident copy with a sibling loader (e.g. across a
            # freeze->unfreeze batch-size switch) instead of re-uploading
            self.dev_images, self.dev_boxes, self.dev_nbox = dev_data
        else:
            self.dev_images, self.dev_boxes, self.dev_nbox = (
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (ds.images, ds.boxes, ds.nbox))
        self._aug = make_device_augment(tuple(input_shape), max_boxes,
                                        resample_dtype=resample_dtype,
                                        out_dtype=out_dtype)
        self._epoch = 0
        self.batches = 0  # batches made: the request id of their spans
        # BatchLoader-compatible accounting (overflow happens at staging)
        self.overflow_items = ds.overflow_items
        self.overflow_dropped = ds.overflow_dropped

    def __len__(self) -> int:
        n = len(self.host_ds.images)
        bs = self.batch_size
        return n // bs if self.drop_last else -(-n // bs)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)
        # pin the iteration RNG stream to the true epoch so a loader rebuilt
        # mid-run (freeze->unfreeze batch-size switch) continues the shuffle/
        # augmentation streams instead of replaying epoch 0's
        self._epoch = epoch

    def throughput(self):
        return None  # the host does almost nothing a batch; the card is the loader

    def augment_batch(self, idx: np.ndarray, params: GeomParams) -> Batch:
        """Run the device program on explicit indices and parameters (all
        their rows; the test hook)."""
        # one host copy of the float parameters, sent without waiting for
        # the card (CUDA copies pageable memory into a staging buffer
        # before the call returns)
        send = lambda a: torch.from_numpy(a).to(self.device, non_blocking=True)
        b = len(idx)
        floats = np.concatenate([np.asarray(x, np.float32).reshape(b, -1)
                                 for x in params[1:]], 1)
        dev_f = send(floats)
        fields, at = [], 0
        for x in params[1:]:
            k = int(np.prod(np.shape(x)[1:]))
            fields.append(dev_f[:, at:at + k].reshape(np.shape(x)))
            at += k
        dev_idx = send(np.array(idx, np.int32))
        dev_p = GeomParams(dev_idx, *fields)
        return Batch(*self._aug(self.dev_images, self.dev_boxes, self.dev_nbox,
                                dev_idx, dev_p))

    def __iter__(self) -> Iterator[Batch]:
        # keep the sampler's epoch gate (mosaic special_aug_ratio) in lockstep
        # with the RNG stream even when the caller never calls set_epoch()
        self.sampler.set_epoch(self._epoch)
        n = len(self.host_ds.images)
        order = np.arange(n)
        rng = np.random.Generator(np.random.PCG64(self.seed + self._epoch))
        if self.shuffle:
            rng.shuffle(order)
        self._epoch += 1
        stop = n - n % self.batch_size if self.drop_last else n
        local = self.batch_size // self.world
        rows = slice(self.rank * local, (self.rank + 1) * local)
        for i in range(0, stop, self.batch_size):
            self.batches += 1
            # the span closes before the yield: the consumer's time between
            # batches is not the loader's
            with span("device_aug.batch", request=self.batches):
                idx = order[i:i + self.batch_size]
                if len(idx) < self.batch_size:  # pad the ragged tail batch
                    idx = np.resize(idx, self.batch_size)
                with span("device_aug.sample"):
                    params = GeomParams(*(x[rows] for x in self.sampler.sample(rng, idx)))
                with span("device_aug.program"):
                    batch = self.augment_batch(params.idx, params)
            yield batch
