"""The single-device train step (`dcfa_yolo_tpu/train/trainer.py:81-112,
230-240, 243-554`; reference `fit_one_epoch`, `utils/utils_fit_mul.py:8-121`).

One step: train-mode forward (BatchNorm on the batch, running statistics
updated), loss, backward, optimizer, EMA.  `eval_step` computes the loss on
the EMA weights in eval mode.  The step is split into `forward`, `loss`,
`backward` and `update` so a caller can time its stages.
"""

from __future__ import annotations

import copy
import warnings
from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from dcfa_yolo_tpu_torch.config import TrainConfig
from dcfa_yolo_tpu_torch.device import resolve_device
from dcfa_yolo_tpu_torch.models.yolo import _DTYPES, DCFAYolo
from dcfa_yolo_tpu_torch.train.ema import ModelEMA
from dcfa_yolo_tpu_torch.train.loss import LossBreakdown, YoloLoss
from dcfa_yolo_tpu_torch.train.optim import Optimizer


class Batch(NamedTuple):
    rgb: torch.Tensor        # (B, H, W, 3) in [0, 1], compute dtype
    nir: torch.Tensor        # (B, H, W, 3)
    gt_boxes: torch.Tensor   # (B, M, 4) xyxy pixels
    gt_labels: torch.Tensor  # (B, M)
    gt_mask: torch.Tensor    # (B, M)


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: Dict
    ema: Dict[str, torch.Tensor]
    ema_updates: int


class Trainer:
    """Owns the model in train mode, the optimizer state and the EMA.

    `train_stem` is the stem graph the steps run ('kernel' or 'plain').
    When 'auto' leaves a CUDA device on the plain graph (kernel C needs an
    sm_90 card, bf16 compute, 16 stem channels and an even input shape),
    the trainer says so once, with a warning."""

    def __init__(self, model: DCFAYolo, train_cfg: TrainConfig = TrainConfig(),
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.cfg = model.cfg
        self.train_stem = model.train_stem_route()
        if (self.train_stem == "plain" and self.device.type == "cuda"
                and self.cfg.train_stem_backend == "auto"):
            warnings.warn(
                f"train stem 'auto' runs the plain graph on {self.device} "
                f"({self.cfg.compute_dtype}, input {self.cfg.input_shape}): "
                "no train-stem kernel is launched", stacklevel=2)
        self.tc = train_cfg
        self.criterion = YoloLoss(self.cfg, train_cfg, self.device)
        self._named = list(self.model.named_parameters())
        self.optimizer = Optimizer(train_cfg, self._named)
        self.ema = ModelEMA(self.model)
        self._eval_model = copy.deepcopy(self.model).eval()
        for p in self._eval_model.parameters():
            p.requires_grad_(False)

    def put_batch(self, rgb, nir, gt_boxes, gt_labels, gt_mask) -> Batch:
        """Host arrays → a Batch on the device; the images go in the compute
        dtype (`trainer.py:511-522`: the model casts them anyway)."""
        dt = _DTYPES[self.cfg.compute_dtype]
        img = lambda a: torch.as_tensor(np.asarray(a)).to(self.device, dt)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(self.device)
        return Batch(img(rgb), img(nir), f32(gt_boxes), f32(gt_labels), f32(gt_mask))

    # -- the stages of one step -----------------------------------------
    def forward(self, batch: Batch):
        return self.model.train_feats(batch.rgb, batch.nir)

    def loss(self, feats, batch: Batch) -> LossBreakdown:
        return self.criterion(feats, batch.gt_boxes, batch.gt_labels, batch.gt_mask)

    def backward(self, total: torch.Tensor) -> Sequence[torch.Tensor]:
        params = [p for _, p in self._named]
        grads = torch.autograd.grad(total, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for g, p in zip(grads, params)]

    def update(self, grads: Sequence[torch.Tensor], lr: float,
               freeze_backbone: bool = False) -> None:
        self.optimizer.step(grads, lr, freeze_backbone)
        self.ema.update(self.model, self.tc.ema_decay, self.tc.ema_tau)

    # ------------------------------------------------------------------
    def train_step(self, batch: Batch, lr: float, freeze_backbone: bool = False
                   ) -> LossBreakdown:
        """One step.  Returns the loss terms as device scalars (no host
        synchronisation)."""
        lb = self.loss(self.forward(batch), batch)
        self.update(self.backward(lb.total), lr, freeze_backbone)
        return LossBreakdown(*(t.detach() for t in lb))

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> LossBreakdown:
        """Validation loss on the EMA weights, eval-mode BN
        (`make_eval_step`, `trainer.py:230-240`)."""
        self._eval_model.load_state_dict(self.ema.variables)
        out = self._eval_model(batch.rgb, batch.nir)
        return self.criterion(out.feats, batch.gt_boxes, batch.gt_labels,
                              batch.gt_mask)

    # ------------------------------------------------------------------
    @property
    def state(self) -> TrainState:
        sd = self.model.state_dict()
        params = {n: p.detach() for n, p in self._named}
        stats = {k: v for k, v in sd.items() if k not in params}
        return TrainState(params, stats, self.optimizer.state(),
                          self.ema.variables, self.ema.updates)

    def ema_variables(self) -> Dict[str, torch.Tensor]:
        """EMA of the parameters and the BN running statistics, by
        state_dict name."""
        return self.ema.variables

    def raw_variables(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.model.state_dict().items()}
