"""The serving pipeline (`dcfa_yolo_tpu/infer/pipeline.py:24-239`):
letterbox → two stems → dual-backbone forward → DFL decode → class-offset
greedy NMS → boxes in original-image [y1, x1, y2, x2] pixels.

Two resolvers pick the implementations: the stem (the fused CUDA kernel
`ops/cuda_stem.py`, or the plain `ConvMaxpool` graph) and the NMS
suppression (`ops/cuda_nms.py`, or its plain version).
"""

from __future__ import annotations

from typing import Tuple

import torch

from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.device import kernels_supported, require_kernels
from dcfa_yolo_tpu_torch.infer.decode import correct_boxes_yxyx, decode_box
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo
from dcfa_yolo_tpu_torch.ops.cuda_stem import STEM_CO, fold_stem_params, stem_eval
from dcfa_yolo_tpu_torch.ops.nms import NMSResult, batched_nms
from dcfa_yolo_tpu_torch.ops.resize import letterbox_batch, letterbox_batch_cf

# the JAX package's stem backend names: its four Pallas canvas layouts are
# one function, served here by the one kernel; its XLA stem is the plain graph
_STEM_NAMES = {"kernel": "kernel", "pallas": "kernel", "pallas_d": "kernel",
               "pallas_e": "kernel", "pallas_f": "kernel",
               "plain": "plain", "xla": "plain"}


def kernel_stem_eligible(cfg: ModelConfig) -> bool:
    """Whether the fused stem kernel applies to this model: 16 stem
    channels, bf16 compute (in float32 the plain graph keeps float32
    precision, as the JAX package's 'auto' does) and an even input shape."""
    return (cfg.base_channels == STEM_CO
            and cfg.compute_dtype == "bfloat16"
            and cfg.input_shape[0] % 2 == 0
            and cfg.input_shape[1] % 2 == 0)


def resolve_stem(stem: str, cfg: ModelConfig, device: torch.device) -> str:
    """'kernel' (the fused stem) or 'plain' (the ConvMaxpool graph).

    'auto' picks the kernel on an sm_90 card (`device.kernels_supported`)
    wherever it applies (`kernel_stem_eligible`).  An explicit kernel
    request that cannot be met raises: on another CUDA card, or for a model
    the kernel does not fit.  On the CPU the kernel's wrapper takes its
    plain version.
    """
    eligible = kernel_stem_eligible(cfg)
    if stem == "auto":
        return "kernel" if eligible and kernels_supported(device) else "plain"
    if stem not in _STEM_NAMES:
        raise ValueError(f"unknown stem backend {stem!r}")
    if _STEM_NAMES[stem] == "kernel":
        if not eligible:
            raise ValueError(
                f"stem={stem!r} needs base_channels={STEM_CO}, bf16 compute and "
                f"an even input shape; cfg has base_channels={cfg.base_channels}, "
                f"compute_dtype={cfg.compute_dtype}, input_shape={cfg.input_shape}")
        if device.type == "cuda":
            require_kernels(device, f"stem={stem!r}")
    return _STEM_NAMES[stem]


def _kernel_stem_outs(model: DCFAYolo, rgb: torch.Tensor, nir: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Letterbox into the kernel's zero-bordered raw canvas and run the
    fused stem per modality (`_pallas_stem_outs`, `pipeline.py:78-173`)."""
    in_hw = tuple(model.cfg.input_shape)
    outs = []
    for img, backbone in ((rgb, model.backbone_rgb), (nir, model.backbone_nir)):
        x_cf = letterbox_batch_cf(img, in_hw)
        stem = backbone.stem
        w, bias = fold_stem_params(stem.conv.weight, stem.bn.weight,
                                   stem.bn.bias, stem.bn.running_mean,
                                   stem.bn.running_var, eps=stem.bn.eps)
        outs.append(stem_eval(x_cf.to(torch.bfloat16).contiguous(), w, bias))
    return outs[0], outs[1]


@torch.inference_mode()
def predict(model: DCFAYolo, rgb, nir, *, stem: str = "auto"
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pipeline up to NMS: per-anchor xyxy boxes normalized to the
    input shape (B, A, 4), best-class scores (B, A) and classes (B, A).

    rgb/nir: (B, H, W, 3) uint8 (numpy or torch), letterboxed to the model's
    input shape on the model's device.
    """
    dev = next(model.parameters()).device
    rgb = torch.as_tensor(rgb, device=dev)
    nir = torch.as_tensor(nir, device=dev)
    in_hw = tuple(model.cfg.input_shape)
    if resolve_stem(stem, model.cfg, dev) == "kernel":
        out = model(None, None, stem_outs=_kernel_stem_outs(model, rgb, nir))
    else:
        # an input already at the model's shape passes through unchanged
        out = model(letterbox_batch(rgb, in_hw) / 255.0,
                    letterbox_batch(nir, in_hw) / 255.0)
    pred = decode_box(out.dbox, out.cls, out.anchors, out.strides, in_hw)
    xywh, scores_all = pred[..., :4], pred[..., 4:]
    boxes = torch.cat([xywh[..., :2] - xywh[..., 2:4] / 2,
                       xywh[..., :2] + xywh[..., 2:4] / 2], dim=-1)
    return boxes, scores_all.amax(dim=-1), scores_all.argmax(dim=-1)


@torch.inference_mode()
def detect_batch(model: DCFAYolo, rgb, nir, image_hw, *, conf_thres: float,
                 iou_thres: float, max_det: int = 300,
                 pre_nms_topk: int = 1024, nms: str = "auto",
                 stem: str = "auto") -> NMSResult:
    """Full pipeline on raw same-sized image pairs (see `predict`).
    image_hw: (B, 2) original (h, w).  Returns NMSResult with boxes in
    original-image [y1, x1, y2, x2] pixels."""
    boxes, scores, classes = predict(model, rgb, nir, stem=stem)
    res = batched_nms(boxes, scores, classes, conf_thres, iou_thres,
                      pre_nms_topk=pre_nms_topk, max_det=max_det, backend=nms)
    image_hw = torch.as_tensor(image_hw, dtype=torch.float32,
                               device=boxes.device)
    boxes_out = correct_boxes_yxyx(res.boxes, tuple(model.cfg.input_shape),
                                   image_hw)
    boxes_out = torch.where(res.valid[..., None], boxes_out, 0.0)
    return res._replace(boxes=boxes_out)
