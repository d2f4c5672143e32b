"""The serving pipeline (`dcfa_yolo_tpu/infer/pipeline.py:24-282`):
letterbox (or a bicubic stretch) → two stems → dual-backbone forward → DFL
decode → class-offset greedy NMS → boxes in original-image [y1, x1, y2, x2]
pixels.

Two resolvers pick the implementations: the stem (the fused CUDA kernel
`ops/cuda_stem.py`, or the plain `ConvMaxpool` graph) and the NMS
suppression (`ops/cuda_nms.py`, or its plain version).

`detect_batch` runs the pipeline op by op.  `detect_batch_graph`, the
counterpart of the JAX `detect_batch_jit`, captures the whole of it, kernels
included, in one `torch.cuda.CUDAGraph` per static key and then replays it;
`heatmap_batch_graph` does the same for the heatmap path.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.device import kernels_supported, require_kernels
from dcfa_yolo_tpu_torch.infer.decode import correct_boxes_yxyx, decode_box
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo
from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem
from dcfa_yolo_tpu_torch.ops.cuda_stem import STEM_CO, fold_stem_params, stem_eval
from dcfa_yolo_tpu_torch.ops.nms import NMSResult, batched_nms, resolve_nms
from dcfa_yolo_tpu_torch.ops.resize import (letterbox_batch, letterbox_batch_cf,
                                            resize_bicubic)
from dcfa_yolo_tpu_torch.utils.profiling import span

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


def _stretch(img: torch.Tensor, in_hw: Tuple[int, int]) -> torch.Tensor:
    """The `letterbox=False` input: a PIL-bicubic stretch to the input
    shape, rounded and clipped to [0, 255] (`pipeline.py:216-220`);
    float32 NHWC."""
    return torch.clamp(torch.round(resize_bicubic(img.float(), in_hw)), 0.0, 255.0)


def _model_input(img: torch.Tensor, in_hw: Tuple[int, int],
                 letterbox: bool) -> torch.Tensor:
    """Raw NHWC images → the model's float32 NHWC input in [0, 255]: the
    letterbox, or for letterbox=False the stretch.  An input already at
    the model's shape is used as it is, as in the JAX package."""
    if tuple(img.shape[1:3]) != in_hw and not letterbox:
        return _stretch(img, in_hw)
    return letterbox_batch(img, in_hw)


def _stem_canvas(img: torch.Tensor, in_hw: Tuple[int, int],
                 letterbox: bool) -> torch.Tensor:
    """Raw NHWC images → the fused stem's 1-px zero-bordered channels-first
    float32 canvas (B, 3, H+2, W+2) (`pipeline.py:142-156`)."""
    if tuple(img.shape[1:3]) != in_hw and not letterbox:
        return F.pad(_stretch(img, in_hw).permute(0, 3, 1, 2), (1, 1, 1, 1))
    return letterbox_batch_cf(img, in_hw)


def _stem_params(model: DCFAYolo, mod: int):
    """Modality `mod`'s (0 rgb, 1 nir) stem conv kernel and BN leaves
    (weight, bias, running mean, running var, eps).  The paired graph's stem
    is block-diagonal (`models/pairing.py`), blocked in and out: the
    modality's kernel is its output rows c·mod:c·(mod+1) and input columns
    3·mod:3·(mod+1), its BN leaves those rows (JAX `pipeline.py:103-120`)."""
    if not model.pair_backbones:
        stem = (model.backbone_rgb, model.backbone_nir)[mod].stem
        bn = stem.bn
        return (stem.conv.weight, bn.weight, bn.bias, bn.running_mean,
                bn.running_var, bn.eps)
    stem = model.backbone_pair.stem
    bn = stem.bn
    c = stem.conv.weight.shape[0] // 2
    co = slice(c * mod, c * (mod + 1))
    return (stem.conv.weight[co, 3 * mod:3 * (mod + 1)], bn.weight[co],
            bn.bias[co], bn.running_mean[co], bn.running_var[co], bn.eps)


def _kernel_stem_outs(model: DCFAYolo, rgb: torch.Tensor, nir: torch.Tensor,
                      letterbox: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's canvas per modality (`_stem_canvas`) through the fused
    stem (`_pallas_stem_outs`, `pipeline.py:78-173`), in the paired graph
    too: the model concatenates the two maps into its paired stem map."""
    in_hw = tuple(model.cfg.input_shape)
    outs = []
    for mod, img in enumerate((rgb, nir)):
        x_cf = _stem_canvas(img, in_hw, letterbox)
        *params, eps = _stem_params(model, mod)
        w, bias = fold_stem_params(*params, eps=eps)
        outs.append(stem_eval(x_cf.to(torch.bfloat16).contiguous(), w, bias))
    return outs[0], outs[1]


def _device(model: DCFAYolo) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def predict(model: DCFAYolo, rgb, nir, *, stem: str = "auto",
            letterbox: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pipeline up to NMS: per-anchor xyxy boxes normalized to the
    input shape (B, A, 4), best-class scores (B, A) and classes (B, A).

    rgb/nir: (B, H, W, 3) uint8 (numpy or torch), letterboxed (or, for
    letterbox=False, stretched) to the model's input shape on the model's
    device.
    """
    dev = _device(model)
    rgb = torch.as_tensor(rgb, device=dev)
    nir = torch.as_tensor(nir, device=dev)
    in_hw = tuple(model.cfg.input_shape)
    if resolve_stem(stem, model.cfg, dev) == "kernel":
        out = model(None, None,
                    stem_outs=_kernel_stem_outs(model, rgb, nir, letterbox))
    else:
        out = model(_model_input(rgb, in_hw, letterbox) / 255.0,
                    _model_input(nir, in_hw, letterbox) / 255.0)
    pred = decode_box(out.dbox, out.cls, out.anchors, out.strides, in_hw)
    xywh, scores_all = pred[..., :4], pred[..., 4:]
    boxes = torch.cat([xywh[..., :2] - xywh[..., 2:4] / 2,
                       xywh[..., :2] + xywh[..., 2:4] / 2], dim=-1)
    return boxes, scores_all.amax(dim=-1), scores_all.argmax(dim=-1)


@torch.inference_mode()
def detect_batch(model: DCFAYolo, rgb, nir, image_hw, *, conf_thres: float,
                 iou_thres: float, letterbox: bool = True, max_det: int = 300,
                 pre_nms_topk: int = 1024, nms: str = "auto",
                 stem: str = "auto") -> NMSResult:
    """Full pipeline on raw same-sized image pairs (see `predict`), op by
    op.  image_hw: (B, 2) original (h, w).  Returns NMSResult with boxes in
    original-image [y1, x1, y2, x2] pixels."""
    boxes, scores, classes = predict(model, rgb, nir, stem=stem,
                                     letterbox=letterbox)
    res = batched_nms(boxes, scores, classes, conf_thres, iou_thres,
                      pre_nms_topk=pre_nms_topk, max_det=max_det, backend=nms)
    image_hw = torch.as_tensor(image_hw, dtype=torch.float32,
                               device=boxes.device)
    boxes_out = correct_boxes_yxyx(res.boxes, tuple(model.cfg.input_shape),
                                   image_hw, letterbox=letterbox)
    boxes_out = torch.where(res.valid[..., None], boxes_out, 0.0)
    return res._replace(boxes=boxes_out)


def heatmap_scores(model: DCFAYolo, rgb: torch.Tensor, nir: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """Per-level max-over-class sigmoid score maps (`pipeline.py:258-270`,
    reference `yolo_mul.py:190-203`): one (B, h, w) map per pyramid level,
    in the compute dtype.  rgb/nir: NHWC model inputs in [0, 1]."""
    out = model(rgb, nir)
    return tuple(torch.sigmoid(f[..., 4 * model.cfg.reg_max:]).amax(dim=-1)
                 for f in out.feats)


@torch.inference_mode()
def heatmap_batch(model: DCFAYolo, rgb_raw, nir_raw) -> Tuple[torch.Tensor, ...]:
    """Letterbox + /255 + `heatmap_scores` on raw (B, H, W, 3) pairs, op
    by op (`heatmap_batch_jit`, `pipeline.py:273-282`)."""
    dev = _device(model)
    in_hw = tuple(model.cfg.input_shape)
    r = letterbox_batch(torch.as_tensor(rgb_raw, device=dev), in_hw) / 255.0
    n = letterbox_batch(torch.as_tensor(nir_raw, device=dev), in_hw) / 255.0
    return heatmap_scores(model, r, n)


# ---------------------------------------------------------------------------
# CUDA graphs: the counterpart of the JAX package's jit.

# the launch counters of the kernels a graph can hold: a wrapper counts a
# launch when it is called, which under capture launches nothing; a replay
# launches what the capture recorded and calls no wrapper
_COUNTED = (cuda_stem, cuda_nms)


class _Graph(NamedTuple):
    """One captured call: its graph, the static input buffers it reads,
    the static outputs it writes, and the kernel launches it holds."""

    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]
    outputs: object
    launches: List[int]


# model → {"pool": memory pool its graphs share, "graphs": {key: _Graph}};
# a model's graphs go with it
_GRAPHS: "weakref.WeakKeyDictionary[DCFAYolo, Dict]" = weakref.WeakKeyDictionary()


def graph_count(model: DCFAYolo) -> int:
    """How many graphs are captured for `model`."""
    entry = _GRAPHS.get(model)
    return len(entry["graphs"]) if entry else 0


def release_graphs(model: DCFAYolo) -> None:
    """Drop `model`'s graphs, their static buffers and their memory pool."""
    _GRAPHS.pop(model, None)


def _capture(model: DCFAYolo, fn: Callable, inputs) -> _Graph:
    """Warm `fn(*inputs)` up eagerly on a side stream, then capture it.

    The warm-up loads the kernel library, passes the kernels' first-call
    checks, queries the stem kernel's grid and fills the constant cache
    (`ops/consts.py`): none of that can run under capture.  A capture that
    fails raises; nothing falls back to the eager call."""
    dev = inputs[0].device
    entry = _GRAPHS.get(model)
    if entry is None:
        entry = _GRAPHS[model] = {"pool": torch.cuda.graph_pool_handle(),
                                  "graphs": {}}
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(*inputs)
    torch.cuda.current_stream(dev).wait_stream(side)
    before = [m.LAUNCHES for m in _COUNTED]
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=entry["pool"]):
            outputs = fn(*inputs)
    finally:
        captured = [m.LAUNCHES - b for m, b in zip(_COUNTED, before)]
        for m, b in zip(_COUNTED, before):  # nothing was launched
            m.LAUNCHES = b
    return _Graph(graph, inputs, outputs, captured)


def _replay(model: DCFAYolo, key, fn: Callable, args):
    """Copy `args` into the static inputs of `model`'s graph for `key`
    (capturing it on the first call), replay it, and return fresh copies
    of its outputs, so that a later replay cannot overwrite a result a
    caller holds."""
    entry = _GRAPHS.get(model)
    g = entry["graphs"].get(key) if entry else None
    if g is None:
        dev = _device(model)
        inputs = tuple(torch.empty(a.shape, dtype=a.dtype, device=dev) for a in args)
        with span("pipeline.copy_in"):
            for buf, a in zip(inputs, args):
                buf.copy_(a)
        with span("pipeline.capture"):
            g = _capture(model, fn, inputs)
        _GRAPHS[model]["graphs"][key] = g
    with span("pipeline.copy_in"):
        for buf, a in zip(g.inputs, args):
            buf.copy_(a)
    with span("pipeline.replay"):
        g.graph.replay()
        for m, n in zip(_COUNTED, g.launches):
            m.LAUNCHES += n
        outs = tuple(t.clone() for t in g.outputs)
    return type(g.outputs)(*outs) if isinstance(g.outputs, NMSResult) else outs


def _cuda_model_device(model: DCFAYolo, what: str) -> torch.device:
    dev = _device(model)
    if dev.type != "cuda":
        raise ValueError(f"{what} captures a CUDA graph and needs a model on a "
                         f"CUDA device, got {dev}; on the CPU call "
                         f"{what.replace('_graph', '')}")
    return dev


def detect_batch_graph(model: DCFAYolo, rgb, nir, image_hw, *, conf_thres: float,
                       iou_thres: float, letterbox: bool = True, max_det: int = 300,
                       pre_nms_topk: int = 1024, nms: str = "auto",
                       stem: str = "auto") -> NMSResult:
    """`detect_batch` as one CUDA graph a key (`detect_batch_jit`,
    `pipeline.py:242-255`): the whole pipeline, kernels A and B included,
    is captured on the first call for a key and replayed after.  The key
    is the JAX jit's static arguments and the shapes it retraces on:
    (batch and input shape and dtype of rgb and nir, conf_thres, iou_thres,
    letterbox, max_det, pre_nms_topk, the resolved NMS and stem).  The
    inputs are copied into the graph's static buffers (the JAX package
    donates them instead); the outputs are fresh tensors.  A graph reads
    the model's weights where they lay at capture: after replacing them,
    call `release_graphs(model)`.  A model on the CPU raises: call
    `detect_batch` there."""
    dev = _cuda_model_device(model, "detect_batch_graph")
    rgb = torch.as_tensor(rgb)
    nir = torch.as_tensor(nir)
    image_hw = torch.as_tensor(image_hw, dtype=torch.float32)
    key = ("detect", tuple(rgb.shape), rgb.dtype, tuple(nir.shape), nir.dtype,
           float(conf_thres), float(iou_thres), bool(letterbox), int(max_det),
           int(pre_nms_topk), resolve_nms(nms, dev),
           resolve_stem(stem, model.cfg, dev))

    def fn(r, n, hw):
        return detect_batch(model, r, n, hw, conf_thres=conf_thres,
                            iou_thres=iou_thres, letterbox=letterbox,
                            max_det=max_det, pre_nms_topk=pre_nms_topk,
                            nms=key[-2], stem=key[-1])

    with torch.inference_mode():
        return _replay(model, key, fn, (rgb, nir, image_hw))


def heatmap_batch_graph(model: DCFAYolo, rgb_raw, nir_raw) -> Tuple[torch.Tensor, ...]:
    """`heatmap_batch` as one CUDA graph a key (batch and input shape and
    dtype), as `detect_batch_graph` does (`heatmap_batch_jit`)."""
    _cuda_model_device(model, "heatmap_batch_graph")
    rgb = torch.as_tensor(rgb_raw)
    nir = torch.as_tensor(nir_raw)
    key = ("heatmap", tuple(rgb.shape), rgb.dtype, tuple(nir.shape), nir.dtype)
    with torch.inference_mode():
        return _replay(model, key, lambda r, n: heatmap_batch(model, r, n),
                       (rgb, nir))
