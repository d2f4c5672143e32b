"""Plain reference of the serving path: the PIL-bicubic letterbox, the eval
forward of the train graph (`reference.model`), the DFL decode, the
letterbox unmap, and a plain greedy NMS (the precision control's own
detections).  float32 throughout; numpy builds the interpolation matrices.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from reference.model import ReferenceYolo


def _cubic(t: np.ndarray, a: float = -0.5) -> np.ndarray:
    at = np.abs(t)
    return np.where(at <= 1.0, (a + 2.0) * at ** 3 - (a + 3.0) * at ** 2 + 1.0,
                    np.where(at < 2.0, a * at ** 3 - 5.0 * a * at ** 2 + 8.0 * a * at - 4.0 * a,
                             0.0))


def pil_cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of PIL's `Image.resize(BICUBIC)` along one
    axis: the support widens on downscale (antialiasing) and each row is
    normalised."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    support = 2.0 * fs
    mat = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        c = (i + 0.5) * scale
        lo, hi = max(int(c - support + 0.5), 0), min(int(c + support + 0.5), n_in)
        w = _cubic((np.arange(lo, hi, dtype=np.float64) - c + 0.5) / fs)
        s = w.sum()
        mat[i, lo:hi] = w / s if s != 0 else w
    return mat.astype(np.float32)


def letterbox(images: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, 3) uint8 → float32 NHWC in [0, 255]: resized by
    min(th/H, tw/W) with PIL's bicubic (horizontal pass, uint8 round,
    vertical pass, round), centred on a gray (128) canvas."""
    ih, iw = images.shape[1:3]
    th, tw = target_hw
    s = min(tw / iw, th / ih)
    nh, nw = int(ih * s), int(iw * s)
    top, left = (th - nh) // 2, (tw - nw) // 2
    x = images.float()
    if (nh, nw) != (ih, iw):
        aw = torch.from_numpy(pil_cubic_matrix(iw, nw)).to(x.device)
        ah = torch.from_numpy(pil_cubic_matrix(ih, nh)).to(x.device)
        x = torch.clamp(torch.round(torch.einsum("qw,bhwc->bhqc", aw, x)), 0, 255)
        x = torch.clamp(torch.round(torch.einsum("ph,bhqc->bpqc", ah, x)), 0, 255)
    out = torch.full((x.shape[0], th, tw, 3), 128.0, device=x.device)
    out[:, top:top + nh, left:left + nw] = x
    return out


class Predictions(NamedTuple):
    """Per anchor, in original-image pixels: boxes (B, A, 4) [y1, x1, y2,
    x2], best-class scores (B, A), classes (B, A)."""

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor


def unmap(xyxy_norm: torch.Tensor, input_hw, image_hw) -> torch.Tensor:
    """Normalised input-space xyxy → original-image [y1, x1, y2, x2]
    pixels, undoing the letterbox's scale and centring."""
    x1, y1, x2, y2 = xyxy_norm.unbind(-1)
    ih, iw = float(image_hw[0]), float(image_hw[1])
    th, tw = float(input_hw[0]), float(input_hw[1])
    s = min(th / ih, tw / iw)
    nh, nw = round(ih * s), round(iw * s)
    oy, ox = (th - nh) / 2.0 / th, (tw - nw) / 2.0 / tw
    sy, sx = th / nh, tw / nw
    cy, cx = ((y1 + y2) / 2 - oy) * sy, ((x1 + x2) / 2 - ox) * sx
    hh, ww = (y2 - y1) * sy, (x2 - x1) * sx
    return torch.stack([(cy - hh / 2) * ih, (cx - ww / 2) * iw,
                        (cy + hh / 2) * ih, (cx + ww / 2) * iw], -1)


@torch.no_grad()
def predict(model: ReferenceYolo, rgb_u8: torch.Tensor, nir_u8: torch.Tensor
            ) -> Predictions:
    """Letterbox, eval forward (in the model's precision), decode and unmap
    of (B, H, W, 3) uint8 pairs."""
    hw = model.sizes.input_hw
    r, n = letterbox(rgb_u8, hw) / 255.0, letterbox(nir_u8, hw) / 255.0
    out = model.eval()(r, n)
    lt, rb = out.dbox.chunk(2, -1)
    a = out.anchors[None]
    xyxy = torch.cat([a - lt, a + rb], -1) * out.strides[None]
    xyxy = xyxy / torch.tensor([hw[1], hw[0], hw[1], hw[0]], dtype=xyxy.dtype,
                               device=xyxy.device)
    scores = torch.sigmoid(out.cls)
    boxes = unmap(xyxy, hw, rgb_u8.shape[1:3])
    return Predictions(boxes, scores.amax(-1), scores.argmax(-1))


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) IoU of [y1, x1, y2, x2] boxes."""
    y1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    x1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    y2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    x2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = (y2 - y1).clamp_min(0) * (x2 - x1).clamp_min(0)
    area = lambda t: (t[:, 2] - t[:, 0]) * (t[:, 3] - t[:, 1])
    return inter / (area(a)[:, None] + area(b)[None, :] - inter + 1e-7)


def greedy_nms(boxes, scores, classes, conf, iou_thres, topk, max_det):
    """One image's detections: the top-k of the scores at or above conf,
    greedy suppression within a class (IoU > iou_thres), the first max_det
    kept.  Returns (boxes, scores, classes) of the kept, by score."""
    ok = scores >= conf
    idx = torch.nonzero(ok)[:, 0]
    order = idx[torch.argsort(scores[idx], descending=True, stable=True)][:topk]
    b, s, c = boxes[order], scores[order], classes[order]
    over = ((iou_matrix(b, b) > iou_thres) & (c[:, None] == c[None, :])).cpu()
    keep = torch.ones(len(order), dtype=torch.bool)
    for i in range(len(order)):
        if keep[i]:
            keep[i + 1:] &= ~over[i, i + 1:]
    kept = torch.nonzero(keep)[:, 0][:max_det].to(boxes.device)
    return b[kept], s[kept], c[kept]
