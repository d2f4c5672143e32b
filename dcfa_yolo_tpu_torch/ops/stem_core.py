"""What the two stem kernels (A, `ops/cuda_stem.py`; C,
`ops/cuda_stem_train.py`) share, on the host side: the persistent tile
schedule and the conv's GEMM packing, the counterparts of
`csrc/stem_core.cuh`.

Schedule.  A tile is TH × TW pooled pixels of one image.  Tiles are numbered
t = (image · tiles_y + tile row) · tiles_x + tile col.  The grid is
`num_ctas` CTAs; CTA i takes tiles i, i + grid, i + 2·grid, …  (the kernels
walk the same order; `tile_grid` repeats their `tiles_x_of`/`tiles_y_of`).
A tile writes its pooled pixels inside the image and, in kernel C, sums the
conv pixels it owns: rows [2·pr0, 2·pr0 + 2·TH) and cols [2·pc0, 2·pc0 +
2·TW) inside the image.

Packing.  The conv is a GEMM of an im2col operand (positions × K) and the
weights (K × 16) with K = 32: rows 0-26 the taps in the order
k = ci·9 + dy·3 + dx, row 27 the bias against an operand column of ones in
kernel A (zero in C), rows 28-31 zero.  `pack_k32` and `im2col_k32` build the
two operands as the kernels' prologue and gather do; the `*_gemm` functions
beside each wrapper use them to compute a kernel's arithmetic in plain
PyTorch (float32 matmul, rounding before the pools).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

TH, TW = 8, 16   # pooled rows and cols per tile (csrc/stem_core.cuh)
K = 32           # GEMM depth: 27 taps, the bias row, 4 zero rows
BIAS_ROW = 27


def tile_grid(b: int, h: int, w: int) -> Tuple[int, int, int]:
    """(tiles_x, tiles_y, n_tiles) of a (b, h, w) stem input, h and w even."""
    tiles_x = (w // 2 + TW - 1) // TW
    tiles_y = (h // 2 + TH - 1) // TH
    return tiles_x, tiles_y, b * tiles_x * tiles_y


def num_ctas(b: int, h: int, w: int, resident: int) -> int:
    """The persistent grid: one CTA for each that fits on the card at once
    (`resident`, from `_build.stem_kernel_info`), but no more than tiles."""
    if resident < 1:
        raise ValueError(f"no CTA of the stem kernel fits on the card ({resident})")
    return min(tile_grid(b, h, w)[2], resident)


def cta_tiles(cta: int, n_cta: int, n_tiles: int) -> range:
    """The tiles CTA `cta` walks, in its order."""
    return range(cta, n_tiles, n_cta)


def tile_origin(t: int, tiles_x: int, tiles_y: int) -> Tuple[int, int, int]:
    """(image, first pooled row, first pooled col) of tile t."""
    per_img = tiles_x * tiles_y
    rem = t % per_img
    return t // per_img, (rem // tiles_x) * TH, (rem % tiles_x) * TW


def pack_k32(weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conv's (32, 16) float32 B operand from the (16, 3, 3, 3) weight:
    rows 0-26 the taps (k = ci·9 + dy·3 + dx), row 27 `bias` (kernel A) or
    zero (kernel C), rows 28-31 zero.  The kernels hold it in bf16 (the
    weights are bf16, and A's bias is a bf16-rounded value)."""
    b = torch.zeros((K, weight.shape[0]), dtype=torch.float32, device=weight.device)
    b[:27] = weight.float().reshape(weight.shape[0], 27).t()
    if bias is not None:
        b[BIAS_ROW] = bias.float()
    return b


def im2col_k32(x_cf: torch.Tensor, ones: bool, padding: int = 0) -> torch.Tensor:
    """The conv's (B, H·W, 32) float32 A operand of a channels-first input
    (B, 3, H + 2 - 2·padding, W + 2 - 2·padding): columns 0-26 the 3×3
    patch in the order k = ci·9 + dy·3 + dx (`F.unfold`'s), column 27 ones
    (`ones`, kernel A) or zero, columns 28-31 zero."""
    cols = F.unfold(x_cf.float(), 3, padding=padding)  # (B, 27, H·W)
    pad = torch.zeros((cols.shape[0], K - 27, cols.shape[2]), dtype=cols.dtype,
                      device=cols.device)
    if ones:
        pad[:, 0] = 1.0
    return torch.cat([cols, pad], 1).transpose(1, 2)


def conv_gemm(x_cf: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              padding: int) -> torch.Tensor:
    """The stem conv as the kernels compute it: im2col (B, H·W, 32) @ (32,
    16) in float32 → (B, 16, H, W) float32, unrounded."""
    b, _, h, w = x_cf.shape
    h, w = h + 2 * padding - 2, w + 2 * padding - 2
    y = im2col_k32(x_cf, bias is not None, padding) @ pack_k32(weight, bias)
    return y.transpose(1, 2).reshape(b, weight.shape[0], h, w)
