"""Greedy NMS suppression as one hand-written CUDA kernel
(`csrc/nms_suppress.cu`).

Port of `dcfa_yolo_tpu/ops/pallas_nms.py` (`pallas_greedy_suppress`: the
per-image `_nms_kernel` and the lane-batched `_nms_kernel_batched`, one
function in two TPU tilings).  Semantics are `ops/nms.py:33-52` of the JAX
package: over score-sorted candidates, candidate i is kept if alive and
suppresses every later j with `iou > thr` (strict, float32).

`greedy_suppress` launches the kernel for a CUDA tensor and uses the plain
version `greedy_suppress_plain` only for a CPU tensor; `LAUNCHES` counts
kernel launches.
"""

from __future__ import annotations

import torch

from dcfa_yolo_tpu_torch.ops import _build

MAX_K = 1024  # shared-memory capacity of the kernel (one CTA per image)
LAUNCHES = 0


def greedy_suppress_plain(boxes: torch.Tensor, alive: torch.Tensor,
                          iou_thres: float) -> torch.Tensor:
    """Plain PyTorch version: one pass per candidate up to the last alive
    one, each kept row's IoU computed on the fly with the Pallas expression
    order, `inter / (area_j + area_i − inter + 1e-7)`.
    boxes (B, K, 4) float32 xyxy, alive (B, K) bool → keep (B, K) bool."""
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    thr = torch.tensor(iou_thres, dtype=torch.float32, device=boxes.device)
    alive = alive.clone()
    k = alive.shape[-1]
    pos = torch.arange(k, device=boxes.device)
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


def greedy_suppress(boxes: torch.Tensor, alive: torch.Tensor,
                    iou_thres: float) -> torch.Tensor:
    """Greedy keep mask.  boxes (B, K, 4) float32 score-sorted xyxy, alive
    (B, K) bool → keep (B, K) bool.  Launches the CUDA kernel for a CUDA
    tensor; a CPU tensor takes `greedy_suppress_plain`."""
    global LAUNCHES
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or alive.shape != boxes.shape[:2]:
        raise ValueError(f"need boxes (B, K, 4) and alive (B, K), got "
                         f"{tuple(boxes.shape)} and {tuple(alive.shape)}")
    if boxes.device.type == "cpu":
        return greedy_suppress_plain(boxes, alive, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"greedy_suppress runs on CUDA or CPU, got {boxes.device}")
    b, k = alive.shape
    if k > MAX_K:
        raise ValueError(f"greedy_suppress takes K <= {MAX_K}, got {k}")
    for name, t, dt in (("boxes", boxes, torch.float32),
                        ("alive", alive, torch.bool)):
        if t.device != boxes.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{boxes.device}, got {t.dtype} on {t.device}")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    lib = _build.load_library()
    rc = lib.nms_suppress(boxes.data_ptr(), alive.data_ptr(), keep.data_ptr(),
                          b, k, float(iou_thres),
                          torch.cuda.current_stream(boxes.device).cuda_stream)
    _build.check(rc, "greedy_suppress")
    LAUNCHES += 1
    return keep
