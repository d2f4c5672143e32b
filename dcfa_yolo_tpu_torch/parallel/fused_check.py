"""Self-check of the fused (SyncBN) data-parallel step on a conv-free
stand-in model (`dcfa_yolo_tpu/parallel/fused_check.py`).

`TinyBNNet` (Dense → the port's BatchNorm → SiLU → Dense, under the flax
scope names `d1`, `bn`, `d2`, so `models/convert.py::from_jax_variables`
carries the JAX module's variables over) is driven through the real port
`Trainer` step code, as the JAX module drives the real `make_train_step`:
the same group, step modes, optimizer tail and EMA.  The BN
running statistics after one fused step over W ranks must be those of the
global batch's moments.  Used by `parallel/dryrun.py` and
tests/test_torch_parallel.py.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
from dcfa_yolo_tpu_torch.ops.norm import BatchNorm
from dcfa_yolo_tpu_torch.parallel.mesh import shard_batch, world_size
from dcfa_yolo_tpu_torch.train.loss import LossBreakdown
from dcfa_yolo_tpu_torch.train.trainer import Trainer

# plain SGD(lr): what the JAX check's optax.sgd(1.0) and its flat-tail
# config compute, and the port's one tail with this config
CHECK_CONFIG = TrainConfig(max_boxes=4, weight_decay=0.0, grad_clip_norm=0.0,
                           momentum=0.0, nesterov=False)


class TinyOut(NamedTuple):
    feats: Any


class Dense(nn.Module):
    """x @ weight (+ bias), the weight in flax's (in, out) layout."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out)) if bias else None

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


class TinyBNNet(nn.Module):
    """Conv-free stand-in with the DCFAYolo surface the trainer reads:
    Dense → BN → SiLU → Dense over the concatenated (B, 2, 2, 3) pair."""

    def __init__(self, n_in: int = 24):
        super().__init__()
        self.cfg = ModelConfig(num_classes=1, input_shape=(2, 2),
                               compute_dtype="float32", train_stem_backend="plain")
        self.d1 = Dense(n_in, 16, bias=False)
        self.bn = BatchNorm(16)
        self.d2 = Dense(16, 8)

    def forward(self, rgb, nir) -> TinyOut:
        x = torch.cat([rgb, nir], dim=-1).reshape(rgb.shape[0], -1)
        h = self.bn(self.d1(x)[:, :, None, None])[:, :, 0, 0]
        return TinyOut(feats=self.d2(F.silu(h)))

    def train_feats(self, rgb, nir):
        return self(rgb, nir).feats

    def train_stem_route(self) -> str:
        return "plain"

    def set_process_group(self, group) -> None:
        self.bn.group = group


class MSECriterion:
    """mean((feats − 1)²) over the global batch: each rank's part is its sum
    over the global count, so the parts add up to the global mean."""

    group = None

    def __call__(self, feats, gt_boxes, gt_labels, gt_mask) -> LossBreakdown:
        t = ((feats - 1.0) ** 2).sum() / (feats.numel() * world_size(self.group))
        return LossBreakdown(total=t, box=t, cls=t * 0, dfl=t * 0)


def setup(n_batch: int = 8, seed: int = 0) -> Tuple[TinyBNNet, Tuple]:
    """The model (weights drawn with numpy from `seed`) and a host batch of
    `n_batch` samples, drawn as the JAX check draws them."""
    model = TinyBNNet()
    rng = np.random.Generator(np.random.PCG64(seed))
    rgb = rng.normal(size=(n_batch, 2, 2, 3)).astype(np.float32)
    nir = rng.normal(size=(n_batch, 2, 2, 3)).astype(np.float32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight") and p.dim() == 2:
                p.copy_(torch.from_numpy(
                    (rng.normal(size=p.shape) / np.sqrt(p.shape[0])).astype(np.float32)))
    z = np.zeros((n_batch, 4), np.float32)
    batch = (rgb, nir, np.zeros((n_batch, 4, 4), np.float32), z, z)
    return model, batch


def make_state(model: nn.Module, group=None, step_mode: str = "fused",
               device="cpu") -> Trainer:
    """The port's trainer (which owns the training state) over `model`."""
    return Trainer(model, CHECK_CONFIG, device=device, step_mode=step_mode,
                   group=group, criterion=MSECriterion())


def host_state(tr: Trainer) -> Dict[str, Dict[str, np.ndarray]]:
    st = tr.state
    return {k: {n: t.detach().cpu().numpy().copy() for n, t in d.items()}
            for k, d in (("params", st.params), ("batch_stats", st.batch_stats))}


def run_fused(model: nn.Module, batch, group=None, rank: int = 0, lr: float = 1e-2,
              step_mode: str = "fused", device="cpu"):
    """One real step of a copy of `model` on this rank's slice of the global
    `batch` over `group` (None: the whole batch in one process).  Returns
    (host {"params", "batch_stats"} state_dicts, loss)."""
    tr = make_state(copy.deepcopy(model), group, step_mode, device)
    local = shard_batch(batch, rank, world_size(group))
    lb = tr.train_step(tr.put_batch(*local), lr)
    return host_state(tr), float(lb.total)


def global_moments(model: TinyBNNet, batch) -> Tuple[np.ndarray, np.ndarray]:
    """The pre-BN activations' mean and biased variance over the whole
    batch, in numpy."""
    x = np.concatenate([batch[0], batch[1]], axis=-1).reshape(len(batch[0]), -1)
    h = x.astype(np.float64) @ model.d1.weight.detach().cpu().numpy().astype(np.float64)
    return h.mean(0), h.var(0)


def rank_checks(rank: int, world: int, group, state_dict, batch, dup) -> Dict:
    """One rank of the check (a `parallel/mesh.py::run_ranks` target): the
    fused step over the global `batch`, and fused and split over `dup`,
    whose per-rank slices are equal."""
    model = TinyBNNet()
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state_dict.items()})
    return {"fused": run_fused(model, batch, group, rank),
            "dup_fused": run_fused(model, dup, group, rank),
            "dup_split": run_fused(model, dup, group, rank, step_mode="split")}
