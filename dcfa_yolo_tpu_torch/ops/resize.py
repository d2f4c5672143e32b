"""Resize ops of the port (`dcfa_yolo_tpu/ops/resize.py:24-151, 292-396`).

  * The neck's bilinear align_corners=True upsample
    (`nets/yolo_mul.py:426,433`) as two products with static interpolation
    matrices, in the activation dtype: the JAX package casts its matrices to
    `x.dtype`, and `F.interpolate` would round elsewhere in bfloat16.
  * The PIL-BICUBIC letterbox of the serving path (`utils/utils.py:24-37`)
    as separable matrices with the gray canvas folded in: `letterbox_batch`
    (NHWC canvas) and `letterbox_batch_cf` (the zero-bordered channels-first
    canvas the fused stem kernel reads).

The matrices are numpy, built once per shape.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix A with out = A @ in, bilinear, align_corners=True."""
    if n_out == 1:
        pos = np.zeros((1,), dtype=np.float64)
    else:
        pos = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.floor(pos).astype(np.int64)
    lo = np.clip(lo, 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    w = pos - lo
    mat = np.zeros((n_out, n_in), dtype=np.float32)
    mat[np.arange(n_out), lo] += (1.0 - w).astype(np.float32)
    mat[np.arange(n_out), hi] += w.astype(np.float32)
    return mat


def _cubic_kernel(t: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic convolution kernel (a=-0.5)."""
    at = np.abs(t)
    at2, at3 = at * at, at * at * at
    return np.where(
        at <= 1.0,
        (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0,
        np.where(at < 2.0, a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def _pil_cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix reproducing PIL `Image.resize(..., BICUBIC)`:
    a support-scaled (antialiased) cubic filter on downscale, with weight
    normalization."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in)
        taps = np.arange(xmin, xmax, dtype=np.float64)
        w = _cubic_kernel((taps - center + 0.5) / filterscale)
        s = w.sum()
        if s != 0:
            w = w / s
        mat[i, xmin:xmax] = w
    return mat.astype(np.float32)


def _letterbox_matrices(ih: int, iw: int, nh: int, nw: int, th: int, tw: int,
                        pad_value: float, border: int):
    """Resize matrices extended with zero rows/cols at the letterbox pad
    positions (plus a zero ring of `border` px), and the constant gray-fill
    image `g`: (th+2b, tw+2b) with pad_value on canvas-minus-image and 0 on
    the image region and the border ring."""
    pad_top = (th - nh) // 2 + border
    pad_left = (tw - nw) // 2 + border
    ah = np.zeros((th + 2 * border, ih), np.float32)
    ah[pad_top:pad_top + nh, :] = _pil_cubic_matrix(ih, nh)
    aw = np.zeros((tw + 2 * border, iw), np.float32)
    aw[pad_left:pad_left + nw, :] = _pil_cubic_matrix(iw, nw)
    g = np.full((th + 2 * border, tw + 2 * border), pad_value, np.float32)
    g[pad_top:pad_top + nh, pad_left:pad_left + nw] = 0.0
    if border:
        g[:border, :] = 0.0
        g[-border:, :] = 0.0
        g[:, :border] = 0.0
        g[:, -border:] = 0.0
    return ah, aw, g


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear align_corners=True resize of an NCHW tensor, as two
    products in x's dtype (rows first, then columns)."""
    h, w = x.shape[2], x.shape[3]
    ah = _const(_linear_matrix(h, out_hw[0]), x)
    aw = _const(_linear_matrix(w, out_hw[1]), x)
    return torch.matmul(torch.matmul(ah, x), aw.t())


def _letterbox_size(images: torch.Tensor, target_hw: Tuple[int, int]):
    ih, iw = images.shape[1], images.shape[2]
    th, tw = target_hw
    scale = min(tw / iw, th / ih)
    return ih, iw, th, tw, int(ih * scale), int(iw * scale)


def letterbox_batch(images: torch.Tensor, target_hw: Tuple[int, int],
                    pad_value: float = 128.0) -> torch.Tensor:
    """Letterbox an NHWC uint8/float batch to `target_hw`: scale =
    min(W/iw, H/ih), PIL-bicubic resize to (nh, nw) with a uint8 round between
    the passes, pasted centered on a gray(128) canvas.  Returns float32 NHWC
    in [0, 255]."""
    ih, iw, th, tw, nh, nw = _letterbox_size(images, target_hw)
    x = images.float()
    if (nh, nw) == (ih, iw):
        pad_top, pad_left = (th - nh) // 2, (tw - nw) // 2
        x = torch.clamp(torch.round(x), 0.0, 255.0)
        x = torch.nn.functional.pad(
            x, (0, 0, pad_left, tw - nw - pad_left, pad_top, th - nh - pad_top),
            value=pad_value)
        return x
    ah, aw, g = _letterbox_matrices(ih, iw, nh, nw, th, tw, pad_value, border=0)
    x = torch.einsum("qw,bhwc->bhqc", _const(aw, x), x)
    x = torch.clamp(torch.round(x), 0.0, 255.0)  # PIL stores uint8 between passes
    x = torch.einsum("ph,bhqc->bpqc", _const(ah, x), x)
    x = torch.clamp(torch.round(x), 0.0, 255.0)
    return x + _const(g, x)[None, :, :, None]


def letterbox_batch_cf(images: torch.Tensor, target_hw: Tuple[int, int],
                       pad_value: float = 128.0) -> torch.Tensor:
    """Letterbox like `letterbox_batch`, but emit the channels-first, 1-px
    ZERO-bordered (B, 3, H+2, W+2) float32 canvas the fused stem kernel
    reads.  The border rides in the resize matrices, the channel transpose
    in the vertical product's output order."""
    ih, iw, th, tw, nh, nw = _letterbox_size(images, target_hw)
    x = images.float()
    if (nh, nw) == (ih, iw):
        x_cf = torch.clamp(torch.round(x.permute(0, 3, 1, 2)), 0.0, 255.0)
        pad_top, pad_left = (th - nh) // 2, (tw - nw) // 2
        x_cf = torch.nn.functional.pad(
            x_cf, (pad_left, tw - nw - pad_left, pad_top, th - nh - pad_top),
            value=pad_value)
        return torch.nn.functional.pad(x_cf, (1, 1, 1, 1))
    ah, aw, g = _letterbox_matrices(ih, iw, nh, nw, th, tw, pad_value, border=1)
    x = torch.einsum("qw,bhwc->bhqc", _const(aw, x), x)
    x = torch.clamp(torch.round(x), 0.0, 255.0)
    x_cf = torch.einsum("ph,bhqc->bcpq", _const(ah, x), x)
    x_cf = torch.clamp(torch.round(x_cf), 0.0, 255.0)
    return x_cf + _const(g, x_cf)[None, None, :, :]
