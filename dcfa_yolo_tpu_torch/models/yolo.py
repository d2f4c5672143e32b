"""DCFA-YOLO model assembly of the port (`dcfa_yolo_tpu/models/yolo.py:72-245`;
reference `nets/yolo_mul.py:328-462`).

Public layouts are the JAX package's: NHWC images in, anchors-first
`(B, A, 4)` / `(B, A, nc)` outputs, NHWC `feats`.  Inside, the NHWC inputs
are permuted into NCHW views (channels_last strides, no copy).
"""

from __future__ import annotations

import contextlib
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.device import resolve_device
from dcfa_yolo_tpu_torch.models.backbone import Backbone
from dcfa_yolo_tpu_torch.models.blocks import (CBAM, C2fRepGhost, ConcatBiFPN,
                                               ConvMaxpool, dfl_decode)
from dcfa_yolo_tpu_torch.models.pairing import (PairedBackbone, PairedCBAM,
                                                PairedConcatBiFPN)
from dcfa_yolo_tpu_torch.ops.boxes import make_anchors_np
from dcfa_yolo_tpu_torch.ops.consts import device_const
from dcfa_yolo_tpu_torch.ops.conv import Conv, ConvBnAct
from dcfa_yolo_tpu_torch.ops.cuda_stem_train import resolve_train_stem
from dcfa_yolo_tpu_torch.ops.norm import BatchNorm, recomputing
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


def _remat_contexts():
    """`checkpoint`'s context_fn: the forward as it is, the recompute
    without running-statistics updates."""
    return contextlib.nullcontext(), recomputing()


class DCFAYolo(nn.Module):
    """Dual-backbone (RGB+NIR) detector with CBAM cross-feature fusion,
    RepGhost PAN neck and YOLOv8 decoupled DFL head.  `train()` / `eval()`
    switch every BatchNorm between batch and running statistics;
    `train_feats` is the train forward.

    deploy / fold_shuffle / pair_backbones / split_neck_concats select the
    serving graphs of JAX `yolo.py:47-69`: RepGhost modules as one biased
    depthwise conv; ShuffleNet units without their final shuffle; both
    backbones as one doubled-channel stream with block-diagonal kernels
    (`models/pairing.py`; eval only, on folded weights); the neck's concats
    into 1x1 convs (the three BiFPN fusions, the down-path concat and each
    C2fRepGhost's own) as sums of part convs (`ops/conv.py::parts_conv`),
    with the same parameters.  The paired graph keeps its neck's concats,
    as in the JAX package.  Their weights come from the train-graph
    state_dict through `models/reparam.py::serving_state_dict`
    (`init_model` applies it)."""

    def __init__(self, cfg: ModelConfig, deploy: bool = False,
                 fold_shuffle: bool = False, pair_backbones: bool = False,
                 split_neck_concats: bool = False):
        super().__init__()
        if pair_backbones and not fold_shuffle:
            raise ValueError("pair_backbones requires fold_shuffle=True "
                             "(pair_backbone_state_dict folds on top of "
                             "fold_shuffle_state_dict)")
        self.cfg = cfg
        self.deploy = deploy
        self.fold_shuffle = fold_shuffle
        self.pair_backbones = pair_backbones
        self.split_neck_concats = split = split_neck_concats and not pair_backbones
        bc, deep, depth = cfg.base_channels, cfg.deep_channels, cfg.base_depth
        if pair_backbones:
            self.backbone_pair = PairedBackbone(bc, deep)
            for i, (c, nb) in enumerate(((bc * 4, 4), (bc * 8, 4), (deep, 2)), start=1):
                self.add_module(f"cbam_pair_feat{i}", PairedCBAM(2 * c, n_blocks=nb))
            # one BiFPN weight shared by all three fusion points, like the
            # reference's single `self.bi_fpn` (`nets/yolo_mul.py:344`)
            self.bi_fpn = PairedConcatBiFPN()
        else:
            self.backbone_rgb = Backbone(bc, deep, cfg.train_stem_backend, fold_shuffle)
            self.backbone_nir = Backbone(bc, deep, cfg.train_stem_backend, fold_shuffle)
            for mod in ("rgb", "nir"):
                for i, c in enumerate((bc * 4, bc * 8, deep), start=1):
                    self.add_module(f"cbam_{mod}_feat{i}", CBAM(c))
            self.bi_fpn = ConcatBiFPN(return_parts=split)
        c2f = dict(n=depth, deploy=deploy, split_concats=split)
        self.conv3_for_upsample1 = C2fRepGhost(deep + 2 * bc * 8, bc * 8, **c2f)
        self.conv3_for_upsample2 = C2fRepGhost(bc * 8 + 2 * bc * 4, bc * 4, **c2f)
        self.down_sample1 = ConvBnAct(bc * 4, bc * 4, 3, 2)
        self.conv3_for_downsample1 = C2fRepGhost(bc * 4 + bc * 8, bc * 8, **c2f)
        self.down_sample2 = ConvBnAct(bc * 8, bc * 8, 3, 2)
        self.conv3_for_downsample2 = C2fRepGhost(bc * 8 + 2 * deep, deep, **c2f)

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

    def _head(self, rgb: Optional[torch.Tensor], nir: Optional[torch.Tensor],
              stem_outs: Optional[Tuple[torch.Tensor, torch.Tensor]]):
        """Backbones, fusion, neck and head → (per-level box and cls maps,
        NCHW, in the compute dtype; the input's (H, W))."""
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

        if self.pair_backbones:
            if self.training:
                raise ValueError("pair_backbones is a serving-only graph")
            feats, feat3 = self._paired_feats(x_rgb, x_nir, s_rgb, s_nir)
        else:
            f1r, f2r, f3r = self._backbone(self.backbone_rgb, x_rgb, s_rgb)
            f1n, f2n, f3n = self._backbone(self.backbone_nir, x_nir, s_nir)
            # per-level, per-modality CBAM before fusion (`nets/yolo_mul.py:346-353`)
            feats = ((self.cbam_rgb_feat1(f1r), self.cbam_nir_feat1(f1n)),
                     (self.cbam_rgb_feat2(f2r), self.cbam_nir_feat2(f2n)),
                     (self.cbam_rgb_feat3(f3r), self.cbam_nir_feat3(f3n)))
            feat3 = feats[2][0] + feats[2][1]  # P5 fusion is an element-wise add (`:421`)

        # PAN neck; upsample sizes come from the feature maps
        p5_up = resize_bilinear_align_corners(feat3, feats[1][0].shape[2:4])
        p4 = self.conv3_for_upsample1(self._fuse(p5_up, feats[1]))
        p4_up = resize_bilinear_align_corners(p4, feats[0][0].shape[2:4])
        p3 = self.conv3_for_upsample2(self._fuse(p4_up, feats[0]))
        down = (self.down_sample1(p3), p4)
        p4 = self.conv3_for_downsample1(down if self.split_neck_concats
                                        else torch.cat(down, dim=1))
        p5 = self.conv3_for_downsample2(self._fuse(self.down_sample2(p4), feats[2]))

        # decoupled head (`nets/yolo_mul.py:387-391,452-453`)
        boxes, clses = [], []
        for i, p in enumerate((p3, p4, p5)):
            box = getattr(self, f"cv2_{i}_0")(p)
            boxes.append(getattr(self, f"cv2_{i}_2")(getattr(self, f"cv2_{i}_1")(box)))
            cls = getattr(self, f"cv3_{i}_0")(p)
            clses.append(getattr(self, f"cv3_{i}_2")(getattr(self, f"cv3_{i}_1")(cls)))
        return boxes, clses, input_hw

    def _backbone(self, backbone: Backbone, x, stem):
        """One backbone; with `cfg.remat` in a train forward that records
        gradients, rematerialized (JAX `yolo.py:138-142`): only its three
        pyramid taps are kept for the backward, which runs it again.  The
        non-reentrant form, since `Trainer.backward` takes
        `torch.autograd.grad` over an explicit parameter list."""
        if self.cfg.remat and self.training and torch.is_grad_enabled():
            # the backbones draw no random numbers: no RNG state to replay
            return checkpoint(backbone, x, stem, use_reentrant=False,
                              context_fn=_remat_contexts, preserve_rng_state=False)
        return backbone(x, stem)

    def _fuse(self, up: torch.Tensor, feat) -> torch.Tensor:
        """One BiFPN fusion of `up` with a level's features: its (rgb, nir)
        maps, or in the paired graph its paired map and block count."""
        if self.pair_backbones:
            return self.bi_fpn(up, *feat)
        return self.bi_fpn((up, *feat))

    def _paired_feats(self, x_rgb, x_nir, s_rgb, s_nir):
        """The paired stream (JAX `yolo.py:96-114`): [rgb | nir] through
        the paired backbone (or the two stem maps, concatenated) and the
        paired CBAMs → ((feat, n_blocks) per level, the P5 sum).  feat3 is
        modality-blocked, so the rgb + nir add is a sum over the modality
        axis."""
        stem = None if s_rgb is None else torch.cat([s_rgb, s_nir], dim=1)
        x = None if x_rgb is None else torch.cat([x_rgb, x_nir], dim=1)
        f1p, f2p, f3p = self.backbone_pair(x, stem)
        f1p, f2p = self.cbam_pair_feat1(f1p), self.cbam_pair_feat2(f2p)
        f3p = self.cbam_pair_feat3(f3p)
        b, c, h, w = f3p.shape
        return ((f1p, 4), (f2p, 4), (f3p, 2)), f3p.view(b, 2, c // 2, h, w).sum(dim=1)

    def set_process_group(self, group) -> None:
        """Share the train-mode BatchNorm moments (both stems' included)
        over the ranks of `group`, as `axis_name` does in the JAX model
        (`backbone.py:23-31`, `yolo.py:70-79`); None makes them local
        again.  A process group does not pickle or deep-copy: copy the
        model before setting one."""
        for m in self.modules():
            if isinstance(m, (BatchNorm, ConvMaxpool)):
                m.group = group

    def train_stem_route(self) -> str:
        """The train-mode stem graph this model runs where its parameters
        lie, for inputs of `cfg.input_shape`: 'kernel' (kernel C) or
        'plain', as `ModelConfig.train_stem_backend` resolves."""
        stem = self.backbone_rgb.stem
        return resolve_train_stem(stem.backend, stem.conv.out_channels,
                                  self.cfg.input_shape,
                                  _DTYPES[self.cfg.compute_dtype],
                                  stem.conv.weight.device)

    def train_feats(self, rgb: torch.Tensor, nir: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
        """The train forward: raw per-level maps `concat([box, cls])`, NHWC
        (B, h, w, 4·reg_max + nc) in the compute dtype, what the loss reads
        (`trainer.py:87-90`).  rgb/nir: (B, H, W, 3) NHWC in [0, 1]."""
        boxes, clses, _ = self._head(rgb, nir, None)
        return tuple(torch.cat([b, c], dim=1).permute(0, 2, 3, 1)
                     for b, c in zip(boxes, clses))

    def forward(self, rgb: Optional[torch.Tensor], nir: Optional[torch.Tensor],
                stem_outs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> YoloOutputs:
        """rgb/nir: (B, H, W, 3) NHWC, /255-normalized; None when
        `stem_outs` (two (B, H/2, W/2, c) NHWC maps from the fused stem
        kernel) replaces the stems."""
        cfg = self.cfg
        boxes, clses, input_hw = self._head(rgb, nir, stem_outs)
        b = boxes[0].shape[0]
        feats = tuple(torch.cat([bx, c], dim=1).permute(0, 2, 3, 1)
                      for bx, c in zip(boxes, clses))
        # levels flatten row-major (y, x), the reference's `.view(b, no, -1)`
        # order; box/cls go to float32 before the DFL
        box_logits = torch.cat([bx.permute(0, 2, 3, 1).reshape(b, -1, 4 * cfg.reg_max)
                                for bx in boxes], dim=1).float()
        cls_logits = torch.cat([c.permute(0, 2, 3, 1).reshape(b, -1, cfg.num_classes)
                                for c in clses], dim=1).float()
        key = (tuple(input_hw), tuple(cfg.strides))
        anchors, strides = (
            device_const(("anchors", i) + key,
                         lambda i=i: make_anchors_np(*key)[i],
                         torch.float32, box_logits.device) for i in range(2))
        return YoloOutputs(
            dbox=dfl_decode(box_logits, cfg.reg_max),
            cls=cls_logits,
            feats=feats,
            anchors=anchors,
            strides=strides,
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


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda",
               train: bool = False, deploy: bool = False,
               fold_shuffle: bool = False, pair_backbones: bool = False,
               split_neck_concats: bool = False) -> DCFAYolo:
    """A DCFAYolo on `device` with deterministic weights made from `seed`
    with numpy (no JAX needed).

    train=False: eval mode, with the lively synthetic weights of
    `_init_value`.  train=True: train mode, at the start of training: the
    flax initial state (BN γ=1, β=0, running mean 0 and var 1, BiFPN w=1)
    with the reference's `weights_init` drawn over it
    (`train/init_weights.py::reference_weights_init`), bit-identical to the
    JAX package's for the same seed.

    The weights are always made for the train graph; deploy / fold_shuffle
    / pair_backbones then transform them (`models/reparam.py`) for the
    serving graph, as JAX `infer/predictor.py:108-140` does;
    split_neck_concats takes them as they are."""
    dev = resolve_device(device)
    model = DCFAYolo(cfg)
    if train:
        from dcfa_yolo_tpu_torch.train.init_weights import reference_weights_init

        reference_weights_init(model, seed)
    else:
        model.load_state_dict(
            {k: torch.from_numpy(_init_value(k, tuple(v.shape), seed))
             for k, v in model.state_dict().items()}, strict=True)
    if deploy or fold_shuffle or pair_backbones or split_neck_concats:
        from dcfa_yolo_tpu_torch.models.reparam import serving_state_dict

        sd = serving_state_dict(model.state_dict(), deploy, fold_shuffle,
                                pair_backbones)
        model = DCFAYolo(cfg, deploy=deploy, fold_shuffle=fold_shuffle,
                         pair_backbones=pair_backbones,
                         split_neck_concats=split_neck_concats)
        model.load_state_dict(sd, strict=True)
    model = model.to(dev)
    return model.train() if train else model.eval()


def count_params(model: nn.Module) -> int:
    """Trainable parameters (BN running statistics are buffers)."""
    return sum(p.numel() for p in model.parameters())
