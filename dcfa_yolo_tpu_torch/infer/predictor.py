"""User-facing detection facade (`dcfa_yolo_tpu/infer/predictor.py:42-346`,
the reference's `YOLO` class, `yolo_mul.py:16-257`): construction from a
checkpoint path or weights (train or deploy graph, folded shuffles,
pre-cast kernels), `detect`, `detect_batch`, `detect_image` and
`draw_detections`, `get_fps`, `detect_heatmap`, the NMS cap counters and
the mAP protocol's detection files (`get_map_txt`, `get_map_txt_batch`).

On the card every call runs the captured pipeline
(`infer/pipeline.py::detect_batch_graph`, one CUDA graph a static key);
on the CPU it runs `detect_batch` op by op.  Only PIL drawing, the heatmap
plot and file IO stay on the host.
"""

from __future__ import annotations

import colorsys
import os
import time
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.device import resolve_device
from dcfa_yolo_tpu_torch.infer.pipeline import (detect_batch, detect_batch_graph,
                                                heatmap_batch, heatmap_batch_graph,
                                                release_graphs)
from dcfa_yolo_tpu_torch.models.convert import from_jax_variables
from dcfa_yolo_tpu_torch.models.reparam import (cast_model_conv_kernels,
                                                serving_state_dict)
from dcfa_yolo_tpu_torch.models.yolo import _DTYPES, DCFAYolo, init_model

_NOT_PORTED = ("{what} is not ported yet (ROADMAP.md, queue 1, item 11: "
               "pair_backbones, split_neck_concats, multi-scale, phi s-x)")


def get_classes(classes_path: str) -> Tuple[List[str], int]:
    """Read class names, one per line (`utils/utils.py:42-46`)."""
    with open(classes_path, encoding="utf-8") as f:
        names = [c.strip() for c in f.readlines()]
    return names, len(names)


def pil_to_rgb_array(image) -> np.ndarray:
    """PIL image or array → (H, W, 3) uint8, converting non-RGB modes
    (`cvtColor`, `utils/utils.py:14-19`)."""
    arr = np.asarray(image)
    if arr.ndim == 3 and arr.shape[2] == 3:
        return arr
    return np.asarray(image.convert("RGB"))


class YOLOPredictor:
    """Detection facade over the serving pipeline, on the card unless
    `device="cpu"` is passed.

    Class names come from `class_names` or, without it, from the file
    `classes_path`.  Weights come from `model_path` (a file in any of the
    four formats of `utils/checkpoint.py::load_variables`, told apart by
    content: a port checkpoint, the reference's `.pth` or `.npz`, imported
    over `init_model(cfg, seed)`'s weights, or the JAX package's msgpack
    `.ckpt`; the EMA weights first, in the train graph's names, then
    transformed for the chosen graph), from
    `variables` (a flax `{"params", "batch_stats"}` tree of arrays, carried
    by `models/convert.py`, that must match the chosen graph: the output of
    the JAX `deploy_variables` for deploy=True, of `fold_shuffle_variables`
    for fold_shuffle=True), from `state_dict` (the port's own, for the
    chosen graph: the training CLI passes its folded EMA weights) or,
    without any, from `init_model(cfg, seed, deploy=..., fold_shuffle=...)`.
    cast_weights pre-casts the conv kernels to the compute dtype
    (`models/reparam.py::cast_model_conv_kernels`), only when that is not
    float32, as in the JAX package.  letterbox_image=False stretches each
    image to the input shape instead of letterboxing it.
    """

    def __init__(self, class_names: Optional[Sequence[str]] = None,
                 input_shape=(640, 640), phi: str = "n",
                 confidence: float = 0.5, nms_iou: float = 0.3,
                 max_det: int = 300, pre_nms_topk: int = 1024,
                 compute_dtype: str = "float32",
                 variables: Optional[Mapping] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                 nms: str = "auto", stem: str = "auto", device="cuda",
                 deploy: bool = False, fold_shuffle: bool = False,
                 cast_weights: bool = False, model_path: Optional[str] = None,
                 classes_path: Optional[str] = None, letterbox_image: bool = True,
                 pair_backbones: bool = False, split_neck_concats: bool = False):
        if pair_backbones:
            raise NotImplementedError(_NOT_PORTED.format(what="pair_backbones"))
        if split_neck_concats:
            raise NotImplementedError(_NOT_PORTED.format(what="split_neck_concats"))
        if class_names is None:
            if classes_path is None:
                raise ValueError("provide classes_path or class_names")
            class_names, _ = get_classes(classes_path)
        self.class_names = list(class_names)
        self.num_classes = len(self.class_names)
        self.confidence = confidence
        self.nms_iou = nms_iou
        self.letterbox_image = letterbox_image
        self.max_det = max_det
        self.pre_nms_topk = pre_nms_topk
        self.nms = nms
        self.stem = stem
        self.device = resolve_device(device)
        self.cfg = ModelConfig(num_classes=self.num_classes, phi=phi,
                               input_shape=tuple(input_shape),
                               compute_dtype=compute_dtype)
        if model_path:
            from dcfa_yolo_tpu_torch.utils.checkpoint import load_variables

            def template():
                return init_model(self.cfg, seed, "cpu").state_dict()

            state_dict = serving_state_dict(load_variables(model_path, template),
                                            deploy, fold_shuffle)
        if variables is not None or state_dict is not None:
            model = DCFAYolo(self.cfg, deploy=deploy, fold_shuffle=fold_shuffle)
            model.load_state_dict(from_jax_variables(variables) if state_dict is None
                                  else state_dict, strict=True)
        else:
            model = init_model(self.cfg, seed, "cpu", deploy=deploy,
                               fold_shuffle=fold_shuffle)
        if cast_weights and compute_dtype != "float32":
            cast_model_conv_kernels(model, _DTYPES[compute_dtype])
        self.model = model.to(self.device).eval()
        # cap-binding counters (the reference NMS is uncapped; these make
        # the fixed-shape caps' deviation observable)
        self.cap_stats = dict(images=0, topk_bound=0, max_det_saturated=0,
                              max_candidates=0)
        hsv = [(x / self.num_classes, 1.0, 1.0) for x in range(self.num_classes)]
        self.colors = [tuple(int(c * 255) for c in colorsys.hsv_to_rgb(*t))
                       for t in hsv]

    def release_graphs(self) -> None:
        """Drop the CUDA graphs captured for this predictor's model."""
        release_graphs(self.model)

    def _run(self, rgb: np.ndarray, nir: np.ndarray,
             confidence: Optional[float]):
        """The pipeline on a (B, H, W, 3) stack of pairs: the captured graph
        on the card, the eager pipeline on the CPU; host numpy results."""
        image_hw = np.tile(np.asarray(rgb.shape[1:3], np.float32), (len(rgb), 1))
        serve = detect_batch_graph if self.device.type == "cuda" else detect_batch
        res = serve(
            self.model, rgb, nir, image_hw,
            conf_thres=self.confidence if confidence is None else confidence,
            iou_thres=self.nms_iou, letterbox=self.letterbox_image,
            max_det=self.max_det, pre_nms_topk=self.pre_nms_topk, nms=self.nms,
            stem=self.stem)
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

    # ------------------------------------------------------------------
    def detect_image(self, image_rgb, image_nir):
        """Draw the detections on the RGB image; returns the annotated PIL
        image (`yolo_mul.py:64-130`)."""
        boxes, scores, labels = self.detect(image_rgb, image_nir)
        return self.draw_detections(image_rgb, boxes, scores, labels)

    def draw_detections(self, image_rgb, boxes, scores, labels):
        """The reference's box and label drawing (`yolo_mul.py:95-129`,
        JAX `predictor.py:214-253`), split from detect_image so that batched
        callers draw what `detect_batch` returns.  PIL's default font where
        `model_data/simhei.ttf` is missing."""
        from PIL import ImageDraw, ImageFont

        if len(boxes) == 0:
            return image_rgb
        try:
            font = ImageFont.truetype(
                font="model_data/simhei.ttf",
                size=int(np.floor(3e-2 * image_rgb.size[1] + 0.5)))
        except OSError:
            font = ImageFont.load_default()
        thickness = int(max(
            (image_rgb.size[0] + image_rgb.size[1]) // np.mean(self.cfg.input_shape), 1))

        for box, score, c in zip(boxes, scores, labels):
            top, left, bottom, right = box
            top = max(0, int(np.floor(top)))
            left = max(0, int(np.floor(left)))
            bottom = min(image_rgb.size[1], int(np.floor(bottom)))
            right = min(image_rgb.size[0], int(np.floor(right)))
            label = f"{self.class_names[int(c)]} {score:.2f}"
            draw = ImageDraw.Draw(image_rgb)
            tl, tt, tr, tb = draw.textbbox((0, 0), label, font=font)
            label_size = (tr - tl, tb - tt)
            origin = ((left, top - label_size[1]) if top - label_size[1] >= 0
                      else (left, top + 1))
            for i in range(thickness):
                if left + i > right - i or top + i > bottom - i:
                    break  # box smaller than the outline inset
                draw.rectangle([left + i, top + i, right - i, bottom - i],
                               outline=self.colors[int(c)])
            draw.rectangle([origin, (origin[0] + label_size[0],
                                     origin[1] + label_size[1])],
                           fill=self.colors[int(c)])
            draw.text(origin, label, fill=(0, 0, 0), font=font)
            del draw
        return image_rgb

    def get_fps(self, image_rgb, image_nir, test_interval: int = 100) -> float:
        """Mean seconds per call of the configured pipeline (captured on the
        card) on one pair, after one warm-up call, each call ending in a
        device synchronise (`predictor.py:256-268`, the reference's
        `get_FPS`)."""
        rgb = pil_to_rgb_array(image_rgb)[None]
        nir = pil_to_rgb_array(image_nir)[None]
        self._run(rgb, nir, None)
        t0 = time.perf_counter()
        for _ in range(test_interval):
            self._run(rgb, nir, None)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return (time.perf_counter() - t0) / test_interval

    def detect_heatmap(self, image_rgb, image_nir, heatmap_save_path: str) -> None:
        """Class-score heatmap over the RGB image, saved as a figure
        (`yolo_mul.py:168-211`).  Needs matplotlib, imported here."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from PIL import Image

        rgb = pil_to_rgb_array(image_rgb)[None]
        nir = pil_to_rgb_array(image_nir)[None]
        # the captured heatmap path on the card, op by op on the CPU
        run = heatmap_batch_graph if self.device.type == "cuda" else heatmap_batch
        maps = [m[0].float().cpu().numpy() for m in run(self.model, rgb, nir)]
        plt.imshow(image_rgb, alpha=1)
        plt.axis("off")
        mask = np.zeros((image_rgb.size[1], image_rgb.size[0]))
        for score in maps:
            score_img = Image.fromarray((score * 255).astype(np.uint8)).resize(
                (image_rgb.size[0], image_rgb.size[1]), Image.BILINEAR)
            mask = np.maximum(mask, np.asarray(score_img))
        plt.imshow(mask, alpha=0.5, interpolation="nearest", cmap="jet")
        plt.axis("off")
        plt.subplots_adjust(top=1, bottom=0, right=1, left=0, hspace=0, wspace=0)
        plt.margins(0, 0)
        os.makedirs(os.path.dirname(os.path.abspath(heatmap_save_path)), exist_ok=True)
        plt.savefig(heatmap_save_path, dpi=200, bbox_inches="tight", pad_inches=-0.1)
        plt.close()
        print("Save to the " + heatmap_save_path)

    # ------------------------------------------------------------------
    def get_map_txt(self, image_id: str, image_rgb, image_nir,
                    class_names: Sequence[str], map_out_path: str,
                    confidence: Optional[float] = None) -> None:
        """Write `detection-results/{id}.txt` lines `cls score x1 y1 x2 y2`
        (`yolo_mul.py:213-257`)."""
        boxes, scores, labels = self.detect(image_rgb, image_nir, confidence=confidence)
        self._write_map_txt(image_id, boxes, scores, labels, class_names,
                            map_out_path)

    def get_map_txt_batch(self, image_ids: Sequence[str], rgb_images,
                          nir_images, class_names: Sequence[str],
                          map_out_path: str,
                          confidence: Optional[float] = None) -> None:
        """Batched `get_map_txt`: one pipeline call for a stack of same-sized
        pairs, the same txt lines."""
        dets = self.detect_batch(rgb_images, nir_images, confidence=confidence)
        for image_id, (boxes, scores, labels) in zip(image_ids, dets):
            self._write_map_txt(image_id, boxes, scores, labels, class_names,
                                map_out_path)

    def _write_map_txt(self, image_id, boxes, scores, labels, class_names,
                       map_out_path) -> None:
        """The JAX package's line format (`predictor.py:335-346`): the score
        as `str(float32)[:6]`, box corners truncated by `int()`, boxes
        stored yxyx."""
        os.makedirs(os.path.join(map_out_path, "detection-results"), exist_ok=True)
        with open(os.path.join(map_out_path, "detection-results", image_id + ".txt"),
                  "w", encoding="utf-8") as f:
            for box, score, c in zip(boxes, scores, labels):
                name = self.class_names[int(c)]
                if name not in class_names:
                    continue
                top, left, bottom, right = box
                f.write(f"{name} {str(score)[:6]} {int(left)} {int(top)} "
                        f"{int(right)} {int(bottom)}\n")
