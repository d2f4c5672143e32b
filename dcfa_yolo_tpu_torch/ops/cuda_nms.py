"""Greedy NMS suppression as hand-written CUDA kernels
(`csrc/nms_suppress.cu`, kernel B).

Port of `dcfa_yolo_tpu/ops/pallas_nms.py` (`pallas_greedy_suppress`: the
per-image `_nms_kernel` and the lane-batched `_nms_kernel_batched`, one
function in two TPU tilings).  Semantics are `ops/nms.py:33-52` of the JAX
package: over score-sorted candidates, candidate i is kept if alive and
suppresses every later j with `iou > thr` (strict, float32).  K has no cap
beyond the scratch's device memory, as the JAX kernel has none.

Kernel B runs in two phases (`csrc/nms_suppress.cu` says how): the IoU
relation as a bitmask (parallel over the upper triangle), then the greedy
scan over it, one warp per image.  Beside the plain version
`greedy_suppress_plain` stand the two phases in plain PyTorch, in the
kernel's bit layout (`mask_layout`): `suppress_mask_plain` and
`scan_keep_plain`.  The tests and `chip_smoke.py` hold the kernel's words
against the first, so that a layout error shows on the CPU too.

`greedy_suppress` launches the kernel for a tensor on an sm_90 card and
uses `greedy_suppress_plain` only for a CPU tensor; `LAUNCHES` counts its
calls on the card (one a call, though a call launches both phases).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dcfa_yolo_tpu_torch.device import require_kernels
from dcfa_yolo_tpu_torch.ops import _build

LAUNCHES = 0
_READY: set = set()  # device indices the kernel ran on: no capability check (µs a call) there
_TILE = 64                      # phase 1's tile side (nms_suppress.cu TILE)
_MAX_TILES = 2 ** 31 - 1        # phase 1's grid.x: the upper triangle's tiles
_MAX_IMAGES = 65535             # phase 1's grid.y
_ROWS_PER_STEP = 512            # suppress_mask_plain's rows a step: bounds its memory


def mask_layout(k: int) -> Tuple[int, int, int]:
    """(NW, W, Kp) of the kernel's bitmask for K candidates: NW = ceil(K/32)
    words hold a row's bits, rows are W words (NW rounded up to a multiple
    of 4, so each starts on 16 bytes), and an image has Kp = 32·NW rows
    (plus one of alive bits in the kernel's scratch)."""
    nw = (k + 31) // 32
    return nw, (nw + 3) // 4 * 4, 32 * nw


def greedy_suppress_plain(boxes: torch.Tensor, alive: torch.Tensor,
                          iou_thres: float) -> torch.Tensor:
    """Plain PyTorch version: one pass per candidate up to the last alive
    one, each kept row's IoU computed on the fly with the Pallas expression
    order, `inter / (area_j + area_i − inter + 1e-7)`.
    boxes (B, K, 4) float32 xyxy, alive (B, K) bool → keep (B, K) bool."""
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    thr = torch.full((), iou_thres, dtype=torch.float32, device=boxes.device)
    alive = alive.clone()
    k = alive.shape[-1]
    pos = torch.arange(k, device=boxes.device)
    if boxes.is_cuda and torch.cuda.is_current_stream_capturing():
        # a CUDA graph cannot read the last alive index back to the host;
        # the passes past it change nothing
        n = k
    else:
        n = int(torch.where(alive, pos + 1, 0).max()) if alive.numel() else 0
    for i in range(n):
        bx1, by1 = x1[:, i:i + 1], y1[:, i:i + 1]
        bx2, by2 = x2[:, i:i + 1], y2[:, i:i + 1]
        iw = torch.clamp(torch.minimum(x2, bx2) - torch.maximum(x1, bx1), min=0.0)
        ih = torch.clamp(torch.minimum(y2, by2) - torch.maximum(y1, by1), min=0.0)
        inter = iw * ih
        iou = inter / (area + area[:, i:i + 1] - inter + 1e-7)
        alive &= ~((iou > thr) & alive[:, i:i + 1] & (pos > i))
    return alive


def _pack_words(bits: torch.Tensor, words: int) -> torch.Tensor:
    """(..., n) bool → (..., words) int64 holding unsigned 32-bit words:
    bit t of word w is entry 32w + t (entries past n are 0)."""
    bits = torch.nn.functional.pad(bits, (0, 32 * words - bits.shape[-1]))
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    return (bits.reshape(*bits.shape[:-1], words, 32).to(torch.int64)
            << shifts).sum(-1)


def suppress_mask_plain(boxes: torch.Tensor, alive: torch.Tensor,
                        iou_thres: float) -> torch.Tensor:
    """Phase 1 of the kernel in plain PyTorch: (B, K, W) int32 words in the
    kernel's layout (`mask_layout`), bit t of word w of row i set when
    i < j = 32w + t < K and IoU(i, j) > thr, with the expression order of
    `greedy_suppress_plain`.  Every row is filled here; the kernel writes
    only the rows and words its scan reads (`scan_reads`).  `alive` only
    fixes the shape: the bits do not depend on it."""
    b, k = alive.shape
    _, w, _ = mask_layout(k)
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    thr = torch.full((), iou_thres, dtype=torch.float32, device=boxes.device)
    col = torch.arange(k, device=boxes.device)
    out = torch.empty((b, k, w), dtype=torch.int64, device=boxes.device)
    for r0 in range(0, k, _ROWS_PER_STEP):
        r = slice(r0, min(r0 + _ROWS_PER_STEP, k))
        iw = torch.clamp(torch.minimum(x2[:, None, :], x2[:, r, None])
                         - torch.maximum(x1[:, None, :], x1[:, r, None]), min=0.0)
        ih = torch.clamp(torch.minimum(y2[:, None, :], y2[:, r, None])
                         - torch.maximum(y1[:, None, :], y1[:, r, None]), min=0.0)
        inter = iw * ih
        iou = inter / (area[:, None, :] + area[:, r, None] - inter + 1e-7)
        later = col[None, None, :] > col[r][None, :, None]
        out[:, r] = _pack_words((iou > thr) & later, w)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def scan_reads(alive: torch.Tensor) -> torch.Tensor:
    """(B, K, W) bool: the words of the mask that the kernel's scan reads,
    words i//32 ≤ w < NW of every alive row i (it reads only rows it
    keeps, and a kept row is alive)."""
    k = alive.shape[-1]
    nw, w, _ = mask_layout(k)
    word = torch.arange(w, device=alive.device)
    first = torch.arange(k, device=alive.device) // 32
    span = (word[None, :] >= first[:, None]) & (word[None, :] < nw)
    return alive[..., None] & span[None]


def scan_keep_plain(mask: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Phase 2 of the kernel in plain PyTorch, with its block walk: removed
    = ~alive; for each block c of 32 candidates up to the last alive one,
    resolve the 32 decisions in order from the diagonal words
    mask[32c + t][c], then OR the kept rows' words w > c into removed.
    mask (B, K, W) int32 in the kernel's layout (words it does not read may
    hold anything), alive (B, K) bool → keep (B, K) bool."""
    b, k = alive.shape
    nw, _, _ = mask_layout(k)
    m = mask.to(torch.int64) & 0xFFFFFFFF
    removed = ~_pack_words(alive, nw) & 0xFFFFFFFF
    pos = torch.arange(k, device=alive.device)
    n = int(torch.where(alive, pos + 1, 0).max()) if alive.numel() else 0
    for c in range((n + 31) // 32):
        rows = range(32 * c, min(32 * c + 32, k))
        rw = removed[:, c]
        for t, i in enumerate(rows):
            rw = torch.where((rw >> t) & 1 == 0, rw | m[:, i, c], rw)
        removed[:, c] = rw
        acc = torch.zeros_like(removed[:, c + 1:])
        for t, i in enumerate(rows):
            kept = ((rw >> t) & 1 == 0)[:, None]
            acc |= torch.where(kept, m[:, i, c + 1:nw], 0)
        removed[:, c + 1:] |= acc
    keep = _unpack_words(~removed & 0xFFFFFFFF)
    return keep[:, :k]


def _unpack_words(words: torch.Tensor) -> torch.Tensor:
    """(B, n) unsigned words in int64 → (B, 32n) bool, bit t of word w at
    32w + t."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    return ((words[..., None] >> shifts) & 1).bool().reshape(words.shape[0], -1)


def greedy_suppress_with_mask(boxes: torch.Tensor, alive: torch.Tensor,
                              iou_thres: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B on the card: keep (B, K) bool and phase 1's words, (B, K, W)
    int32 (a view of the scratch; only `scan_reads` words are written)."""
    _check_shapes(boxes, alive)
    keep, scratch = _launch(boxes, alive, iou_thres)
    return keep, scratch[:, :alive.shape[1]]


def _launch(boxes: torch.Tensor, alive: torch.Tensor, iou_thres: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both phases on the current stream: nothing waits for the host and
    nothing is copied to the device.  The scratch, B·(Kp+1)·W·4 bytes
    (1 MB at B=8, K=1024; 71 MB at B=8, K=8400), comes from PyTorch's
    caching allocator.  Returns keep and the whole scratch."""
    global LAUNCHES
    dev = boxes.device
    if dev.index not in _READY:
        require_kernels(dev, "greedy_suppress")
    b, k = alive.shape
    n_side = -(-k // _TILE)
    if b > _MAX_IMAGES or n_side * (n_side + 1) // 2 > _MAX_TILES:
        raise ValueError(f"greedy_suppress takes B <= {_MAX_IMAGES} and K up to "
                         f"about 4.19e6 (phase 1's grid), got B={b}, K={k}")
    if (boxes.dtype != torch.float32 or alive.dtype != torch.bool
            or alive.device != dev or not boxes.is_contiguous()
            or not alive.is_contiguous()):
        raise ValueError(f"need contiguous float32 boxes and bool alive on one "
                         f"device, got {boxes.dtype} on {dev} and {alive.dtype} "
                         f"on {alive.device}")
    _, w, kp = mask_layout(k)
    keep = torch.empty((b, k), dtype=torch.bool, device=dev)
    scratch = torch.empty((b, kp + 1, w), dtype=torch.int32, device=dev)
    if b and k:
        lib = _build.load_library()
        # the raw stream getter costs a fraction of torch.cuda.current_stream,
        # and the serving path calls this once a request
        rc = lib.nms_suppress(boxes.data_ptr(), alive.data_ptr(), scratch.data_ptr(),
                              w, keep.data_ptr(), b, k, float(iou_thres),
                              torch._C._cuda_getCurrentRawStream(dev.index))
        _build.check(rc, "greedy_suppress")
        _READY.add(dev.index)
        LAUNCHES += 1
    return keep, scratch


def greedy_suppress(boxes: torch.Tensor, alive: torch.Tensor,
                    iou_thres: float) -> torch.Tensor:
    """Greedy keep mask.  boxes (B, K, 4) float32 score-sorted xyxy, alive
    (B, K) bool → keep (B, K) bool.  Launches the CUDA kernel for a tensor
    on an sm_90 card and raises on another card; a CPU tensor takes
    `greedy_suppress_plain`."""
    _check_shapes(boxes, alive)
    if boxes.device.type == "cpu":
        return greedy_suppress_plain(boxes, alive, iou_thres)
    return _launch(boxes, alive, iou_thres)[0]


def _check_shapes(boxes: torch.Tensor, alive: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or alive.shape != boxes.shape[:2]:
        raise ValueError(f"need boxes (B, K, 4) and alive (B, K), got "
                         f"{tuple(boxes.shape)} and {tuple(alive.shape)}")
