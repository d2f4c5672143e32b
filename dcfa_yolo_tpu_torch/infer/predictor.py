"""User-facing detection facade (`dcfa_yolo_tpu/infer/predictor.py:42-207`),
minimal: construction, `detect`, `detect_batch` and the NMS cap counters.
Drawing, fps, heatmaps, map-txt output and checkpoint loading are not
ported yet (ROADMAP.md)."""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.device import resolve_device
from dcfa_yolo_tpu_torch.infer.pipeline import detect_batch
from dcfa_yolo_tpu_torch.models.convert import from_jax_variables
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo, init_model


def pil_to_rgb_array(image) -> np.ndarray:
    """PIL image or array → (H, W, 3) uint8, converting non-RGB modes."""
    arr = np.asarray(image)
    if arr.ndim == 3 and arr.shape[2] == 3:
        return arr
    return np.asarray(image.convert("RGB"))


class YOLOPredictor:
    """Detection facade over the serving pipeline, on the card unless
    `device="cpu"` is passed.

    Weights come from `variables` (a flax `{"params", "batch_stats"}` tree
    of arrays, carried by `models/convert.py`) or, without them, from
    `init_model(cfg, seed)`.
    """

    def __init__(self, class_names: Sequence[str], input_shape=(640, 640),
                 phi: str = "n", confidence: float = 0.5,
                 nms_iou: float = 0.3, max_det: int = 300,
                 pre_nms_topk: int = 1024, compute_dtype: str = "float32",
                 variables: Optional[Mapping] = None, seed: int = 0,
                 nms: str = "auto", stem: str = "auto", device="cuda"):
        self.class_names = list(class_names)
        self.num_classes = len(self.class_names)
        self.confidence = confidence
        self.nms_iou = nms_iou
        self.max_det = max_det
        self.pre_nms_topk = pre_nms_topk
        self.nms = nms
        self.stem = stem
        self.device = resolve_device(device)
        self.cfg = ModelConfig(num_classes=self.num_classes, phi=phi,
                               input_shape=tuple(input_shape),
                               compute_dtype=compute_dtype)
        if variables is not None:
            model = DCFAYolo(self.cfg)
            model.load_state_dict(from_jax_variables(variables), strict=True)
            self.model = model.to(self.device).eval()
        else:
            self.model = init_model(self.cfg, seed, self.device)
        # cap-binding counters (the reference NMS is uncapped; these make
        # the fixed-shape caps' deviation observable)
        self.cap_stats = dict(images=0, topk_bound=0, max_det_saturated=0,
                              max_candidates=0)

    def _run(self, rgb: np.ndarray, nir: np.ndarray,
             confidence: Optional[float]):
        image_hw = np.tile(np.asarray(rgb.shape[1:3], np.float32), (len(rgb), 1))
        res = detect_batch(
            self.model, rgb, nir, image_hw,
            conf_thres=self.confidence if confidence is None else confidence,
            iou_thres=self.nms_iou, max_det=self.max_det,
            pre_nms_topk=self.pre_nms_topk, nms=self.nms, stem=self.stem)
        res = type(res)(*(t.cpu().numpy() for t in res))
        self._note_caps(res)
        return res

    def _note_caps(self, res) -> None:
        """Accumulate fixed-cap binding counters from one host-side result."""
        nc = res.n_candidates
        self.cap_stats["images"] += int(len(nc))
        self.cap_stats["topk_bound"] += int((nc > self.pre_nms_topk).sum())
        self.cap_stats["max_det_saturated"] += int(
            (res.valid.sum(-1) >= self.max_det).sum())
        self.cap_stats["max_candidates"] = max(
            self.cap_stats["max_candidates"], int(nc.max()))

    def detect(self, image_rgb, image_nir, confidence: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(boxes_yxyx_px, scores, class_ids) for one image pair."""
        rgb = pil_to_rgb_array(image_rgb)[None]
        nir = pil_to_rgb_array(image_nir)[None]
        res = self._run(rgb, nir, confidence)
        n = int(res.valid[0].sum())
        return res.boxes[0][:n], res.scores[0][:n], res.classes[0][:n]

    def detect_batch(self, rgb_images, nir_images,
                     confidence: Optional[float] = None):
        """Batched detection over same-sized pairs (lists of PIL images or
        (B, H, W, 3) uint8 arrays) in one pipeline call.  Returns a list of
        (boxes_yxyx_px, scores, class_ids)."""
        rgb = (rgb_images if isinstance(rgb_images, np.ndarray)
               else np.stack([pil_to_rgb_array(i) for i in rgb_images]))
        nir = (nir_images if isinstance(nir_images, np.ndarray)
               else np.stack([pil_to_rgb_array(i) for i in nir_images]))
        res = self._run(rgb, nir, confidence)
        out = []
        for b in range(len(rgb)):
            n = int(res.valid[b].sum())
            out.append((res.boxes[b][:n], res.scores[b][:n], res.classes[b][:n]))
        return out
