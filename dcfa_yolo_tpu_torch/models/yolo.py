"""DCFA-YOLO model assembly of the port (`dcfa_yolo_tpu/models/yolo.py:72-245`,
the non-paired branch; reference `nets/yolo_mul.py:328-462`).

Public layouts are the JAX package's: NHWC images in, anchors-first
`(B, A, 4)` / `(B, A, nc)` outputs, NHWC `feats`.  Inside, the NHWC inputs
are permuted into NCHW views (channels_last strides, no copy).
"""

from __future__ import annotations

import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.device import resolve_device
from dcfa_yolo_tpu_torch.models.backbone import Backbone
from dcfa_yolo_tpu_torch.models.blocks import (CBAM, C2fRepGhost, ConcatBiFPN,
                                               dfl_decode)
from dcfa_yolo_tpu_torch.ops.boxes import make_anchors_np
from dcfa_yolo_tpu_torch.ops.conv import Conv, ConvBnAct
from dcfa_yolo_tpu_torch.ops.resize import resize_bilinear_align_corners

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class YoloOutputs(NamedTuple):
    """Forward outputs in the JAX package's anchors-first layout."""

    dbox: torch.Tensor        # (B, A, 4) DFL-decoded ltrb distances (feature units)
    cls: torch.Tensor         # (B, A, nc) raw class logits, float32
    feats: Tuple[torch.Tensor, ...]  # raw per-level maps, NHWC (B, h, w, no)
    anchors: torch.Tensor     # (A, 2) grid centers, feature units
    strides: torch.Tensor     # (A, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class DCFAYolo(nn.Module):
    """Dual-backbone (RGB+NIR) detector with CBAM cross-feature fusion,
    RepGhost PAN neck and YOLOv8 decoupled DFL head (train-graph weights,
    eval forward)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        bc, deep, depth = cfg.base_channels, cfg.deep_channels, cfg.base_depth
        self.backbone_rgb = Backbone(bc, deep)
        self.backbone_nir = Backbone(bc, deep)
        for mod in ("rgb", "nir"):
            for i, c in enumerate((bc * 4, bc * 8, deep), start=1):
                self.add_module(f"cbam_{mod}_feat{i}", CBAM(c))
        # one ConcatBiFPN shared by all three fusion points, like the
        # reference's single `self.bi_fpn` (`nets/yolo_mul.py:344`)
        self.bi_fpn = ConcatBiFPN()
        self.conv3_for_upsample1 = C2fRepGhost(deep + 2 * bc * 8, bc * 8, depth)
        self.conv3_for_upsample2 = C2fRepGhost(bc * 8 + 2 * bc * 4, bc * 4, depth)
        self.down_sample1 = ConvBnAct(bc * 4, bc * 4, 3, 2)
        self.conv3_for_downsample1 = C2fRepGhost(bc * 4 + bc * 8, bc * 8, depth)
        self.down_sample2 = ConvBnAct(bc * 8, bc * 8, 3, 2)
        self.conv3_for_downsample2 = C2fRepGhost(bc * 8 + 2 * deep, deep, depth)

        ch = cfg.feat_channels
        c2 = max(16, ch[0] // 4, cfg.reg_max * 4)
        c3 = max(ch[0], cfg.num_classes)
        for i, c in enumerate(ch):
            self.add_module(f"cv2_{i}_0", ConvBnAct(c, c2, 3))
            self.add_module(f"cv2_{i}_1", ConvBnAct(c2, c2, 3))
            self.add_module(f"cv2_{i}_2", Conv(c2, 4 * cfg.reg_max, 1, bias=True))
            self.add_module(f"cv3_{i}_0", ConvBnAct(c, c3, 3))
            self.add_module(f"cv3_{i}_1", ConvBnAct(c3, c3, 3))
            self.add_module(f"cv3_{i}_2", Conv(c3, cfg.num_classes, 1, bias=True))

    def forward(self, rgb: Optional[torch.Tensor], nir: Optional[torch.Tensor],
                stem_outs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> YoloOutputs:
        """rgb/nir: (B, H, W, 3) NHWC, /255-normalized; None when
        `stem_outs` (two (B, H/2, W/2, c) NHWC maps from the fused stem
        kernel) replaces the stems."""
        cfg = self.cfg
        dtype = _DTYPES[cfg.compute_dtype]
        if stem_outs is not None:
            s_rgb, s_nir = (_nchw(s.to(dtype)) for s in stem_outs)
            x_rgb = x_nir = None
            input_hw = (stem_outs[0].shape[1] * 2, stem_outs[0].shape[2] * 2)
        else:
            s_rgb = s_nir = None
            x_rgb, x_nir = _nchw(rgb.to(dtype)), _nchw(nir.to(dtype))
            input_hw = (rgb.shape[1], rgb.shape[2])

        f1r, f2r, f3r = self.backbone_rgb(x_rgb, s_rgb)
        f1n, f2n, f3n = self.backbone_nir(x_nir, s_nir)
        # per-level, per-modality CBAM before fusion (`nets/yolo_mul.py:346-353`)
        f1r, f1n = self.cbam_rgb_feat1(f1r), self.cbam_nir_feat1(f1n)
        f2r, f2n = self.cbam_rgb_feat2(f2r), self.cbam_nir_feat2(f2n)
        f3r, f3n = self.cbam_rgb_feat3(f3r), self.cbam_nir_feat3(f3n)
        feat3 = f3r + f3n  # P5 fusion is an element-wise add (`:421`)

        # PAN neck; upsample sizes come from the feature maps
        p5_up = resize_bilinear_align_corners(feat3, f2r.shape[2:4])
        p4 = self.conv3_for_upsample1(self.bi_fpn((p5_up, f2r, f2n)))
        p4_up = resize_bilinear_align_corners(p4, f1r.shape[2:4])
        p3 = self.conv3_for_upsample2(self.bi_fpn((p4_up, f1r, f1n)))
        p4 = self.conv3_for_downsample1(
            torch.cat([self.down_sample1(p3), p4], dim=1))
        p5 = self.conv3_for_downsample2(
            self.bi_fpn((self.down_sample2(p4), f3r, f3n)))

        # decoupled head (`nets/yolo_mul.py:387-391,452-453`)
        b = p3.shape[0]
        feats, boxes_l, clses_l = [], [], []
        for i, p in enumerate((p3, p4, p5)):
            box = getattr(self, f"cv2_{i}_0")(p)
            box = getattr(self, f"cv2_{i}_2")(getattr(self, f"cv2_{i}_1")(box))
            cls = getattr(self, f"cv3_{i}_0")(p)
            cls = getattr(self, f"cv3_{i}_2")(getattr(self, f"cv3_{i}_1")(cls))
            feats.append(torch.cat([box, cls], dim=1).permute(0, 2, 3, 1))
            boxes_l.append(box.permute(0, 2, 3, 1).reshape(b, -1, 4 * cfg.reg_max))
            clses_l.append(cls.permute(0, 2, 3, 1).reshape(b, -1, cfg.num_classes))
        # levels flatten row-major (y, x), the reference's `.view(b, no, -1)`
        # order; box/cls go to float32 before the DFL
        box_logits = torch.cat(boxes_l, dim=1).float()
        cls_logits = torch.cat(clses_l, dim=1).float()
        anchors_np, strides_np = make_anchors_np(tuple(input_hw), cfg.strides)
        dev = box_logits.device
        return YoloOutputs(
            dbox=dfl_decode(box_logits, cfg.reg_max),
            cls=cls_logits,
            feats=tuple(feats),
            anchors=torch.from_numpy(anchors_np).to(dev),
            strides=torch.from_numpy(strides_np).to(dev),
        )


def _init_value(name: str, shape, seed: int) -> np.ndarray:
    """Deterministic value of one state_dict entry from a numpy generator
    keyed by (seed, name), with the distributions of the JAX package's
    synthetic parity weights (`utils/golden.py::synth_value`): conv kernels
    N(0, 0.05), BN scale N(1, 0.1), biases N(0, 0.05), running means
    N(0, 0.2), running vars and BiFPN weights U(0.5, 1.5).  They keep the
    eval forward numerically lively, so scores and boxes spread."""
    rng = np.random.Generator(np.random.PCG64(
        seed * 1_000_003 + zlib.crc32(name.encode())))
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("running_var", "w"):
        v = rng.uniform(0.5, 1.5, size=shape)
    elif leaf == "running_mean":
        v = rng.standard_normal(shape) * 0.2
    elif leaf == "weight" and len(shape) == 1:
        v = 1.0 + rng.standard_normal(shape) * 0.1
    else:
        v = rng.standard_normal(shape) * 0.05
    return v.astype(np.float32)


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda") -> DCFAYolo:
    """A DCFAYolo in eval mode on `device` with deterministic weights made
    from `seed` with numpy (no JAX needed)."""
    dev = resolve_device(device)
    model = DCFAYolo(cfg)
    sd = {k: torch.from_numpy(_init_value(k, tuple(v.shape), seed))
          for k, v in model.state_dict().items()}
    model.load_state_dict(sd, strict=True)
    return model.to(dev).eval()


def count_params(model: nn.Module) -> int:
    """Trainable parameters (BN running statistics are buffers)."""
    return sum(p.numel() for p in model.parameters())
