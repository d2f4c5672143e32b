"""The optimizer and EMA tail on flat float32 vectors
(`dcfa_yolo_tpu/train/flat_opt.py`), the trainer's default tail.

The parameters live as views into one float32 vector, the BN running
statistics into another (`flatten_into`), so the tail runs a few large
elementwise ops on whole vectors instead of several per parameter, and the
flat gradient is the one buffer data-parallel training all-reduces.  The
chain is `train/optim.py`'s, in optax's order:

    clip_by_global_norm → masked coupled weight decay (conv kernels only)
    → nesterov SGD momentum | Adam → BiFPN update zeroed (untrained)
    → scale(−1)

and the EMA ramp d(u) = decay · (1 − e^(−u/τ)) runs over the parameters and
the BN statistics.  The masks come once from the parameter names
(`optim.py`'s predicates).  Each elementwise op is the one `optim.py` and
`ema.py` apply per tensor, and the clip's global norm is taken over the
same per-parameter norms, so on the CPU the flat tail is bit-equal to the
per-tensor path (`Trainer(flat_tail=False)`).

The values that change from step to step (the learning rate, the EMA's d
and 1 − d, Adam's bias corrections) are 0-dim float32 tensors on the
vectors' device, written by `advance` before each step (`fill_`, the value
rounded to float32 as the Python-float path rounds it); `apply` launches
the step's kernels and reads them there, so a CUDA graph captured around
`apply` serves every step.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from dcfa_yolo_tpu_torch.config import TrainConfig
from dcfa_yolo_tpu_torch.train.ema import ema_decay
from dcfa_yolo_tpu_torch.train.optim import (ADAM_B2, ADAM_EPS, bifpn, decays,
                                             frozen)


class FlatSGD(NamedTuple):
    trace: torch.Tensor         # (P,) momentum buffer


class FlatAdam(NamedTuple):
    count: int
    mu: torch.Tensor            # (P,)
    nu: torch.Tensor            # (P,)


class FlatLayout:
    """Where each named tensor sits in a flat vector: names, shapes and
    offsets in the given order."""

    def __init__(self, named: Sequence[Tuple[str, torch.Tensor]]):
        self.names = [n for n, _ in named]
        self.shapes = [t.shape for _, t in named]
        self.sizes = [t.numel() for _, t in named]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).tolist()
        self.n = self.offsets[-1]

    def ravel(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """One new float32 vector of `tensors`, in this layout's order."""
        return torch.cat([t.detach().reshape(-1).float() for t in tensors])

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Views of `flat` shaped as the named tensors."""
        return [flat[o:o + n].view(s)
                for o, n, s in zip(self.offsets, self.sizes, self.shapes)]


def flatten_into(named: Sequence[Tuple[str, torch.Tensor]]) -> torch.Tensor:
    """Copy float32 tensors (parameters or buffers) into one new vector, in
    `FlatLayout(named)`'s order, and make each tensor a view of its slice in
    place (`.data`), so that the modules holding them read and write the
    vector."""
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}: the flat tail holds float32")
    layout = FlatLayout(named)
    flat = layout.ravel([t for _, t in named])
    for (_, t), v in zip(named, layout.views(flat)):
        t.data = v
    return flat


class FlatFactors(NamedTuple):
    """The static factors of the tail, built once from the names."""

    layout: FlatLayout
    decay: torch.Tensor         # (P,) 1 where weight decay applies
    live_bifpn: torch.Tensor    # (P,) 0 on bi_fpn.w when it is untrained
    live_frozen: torch.Tensor   # (P,) 0 inside the modal backbones
    frozen: List[bool]          # per parameter, inside the modal backbones


def build_factors(named: Sequence[Tuple[str, torch.Tensor]],
                  train_bifpn: bool = True, device=None) -> FlatFactors:
    """Masks from the parameter names and shapes (`optim.py`'s predicates),
    on `device` (default: the first tensor's)."""
    layout = FlatLayout(named)
    device = named[0][1].device if device is None else device

    def mask(pred):
        return torch.cat([torch.full((t.numel(),), float(pred(n, t)))
                          for n, t in named]).to(device)

    return FlatFactors(
        layout=layout, decay=mask(decays),
        live_bifpn=mask(lambda n, t: train_bifpn or not bifpn(n)),
        live_frozen=mask(lambda n, t: not frozen(n)),
        frozen=[frozen(n) for n in layout.names])


def init_flat_opt(cfg: TrainConfig, n_params: int, device="cpu"
                  ) -> Union[FlatSGD, FlatAdam]:
    zeros = lambda: torch.zeros(n_params, dtype=torch.float32, device=device)
    if cfg.optimizer_type == "sgd":
        return FlatSGD(trace=zeros())
    if cfg.optimizer_type == "adam":
        return FlatAdam(count=0, mu=zeros(), nu=zeros())
    raise ValueError(cfg.optimizer_type)


def global_norm(g: torch.Tensor, factors: FlatFactors,
                freeze_backbone: bool = False) -> torch.Tensor:
    """The clip's global norm: the norm of the per-parameter norms of the
    live parameters, as `optim.py` reduces it."""
    views = [v for v, fr in zip(factors.layout.views(g), factors.frozen)
             if not (freeze_backbone and fr)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(views)))


def adam_bias(count: int, b1: float) -> Tuple[float, float]:
    """Adam's bias corrections 1 − β₁ᵗ and 1 − β₂ᵗ at step `count`, in
    float32 arithmetic."""
    f32 = np.float32
    c = f32(count)
    return float(f32(1.0) - f32(b1) ** c), float(f32(1.0) - f32(ADAM_B2) ** c)


def scalar(device) -> torch.Tensor:
    """A 0-dim float32 tensor on `device`, for a per-step value."""
    return torch.zeros((), dtype=torch.float32, device=device)


@torch.no_grad()
def flat_update(cfg: TrainConfig, factors: FlatFactors, g: torch.Tensor,
                p: torch.Tensor, opt: Union[FlatSGD, FlatAdam],
                freeze_backbone: bool = False):
    """One optimizer step on flat vectors: returns (updates, opt) with
    `new_p = p + lr · updates` (the scale(−1) applied) and Adam's count
    advanced.  The state tensors of `opt` are updated in place; `g` is not
    modified.  In the freeze phase the backbones' entries take no step,
    count in no norm and keep a zero state."""
    bias = None
    if isinstance(opt, FlatAdam):
        opt = opt._replace(count=opt.count + 1)
        bias = adam_bias(opt.count, cfg.momentum)
    return flat_updates(cfg, factors, g, p, opt, freeze_backbone, bias), opt


@torch.no_grad()
def flat_updates(cfg: TrainConfig, factors: FlatFactors, g: torch.Tensor,
                 p: torch.Tensor, opt: Union[FlatSGD, FlatAdam],
                 freeze_backbone: bool = False, bias=None) -> torch.Tensor:
    """`flat_update`'s kernels alone: the updates, with Adam's bias
    corrections `bias` given (floats, or 0-dim tensors written before the
    step) and its count left as it is."""
    live = factors.live_frozen if freeze_backbone else None
    if live is not None:
        g = g * live
    if cfg.grad_clip_norm > 0:
        # optax.clip_by_global_norm: g below the limit, else (g / norm) · max
        norm = global_norm(g, factors, freeze_backbone)
        under = norm < cfg.grad_clip_norm
        g = (g / torch.where(under, 1.0, norm)) * torch.where(under, 1.0, cfg.grad_clip_norm)
    if cfg.weight_decay > 0:
        g = g + cfg.weight_decay * p * factors.decay
    if isinstance(opt, FlatSGD):
        opt.trace.mul_(cfg.momentum).add_(g)
        upd = g + opt.trace * cfg.momentum if cfg.nesterov else opt.trace.clone()
        if live is not None:
            opt.trace.mul_(live)
    else:
        b1, b2 = cfg.momentum, ADAM_B2
        opt.mu.mul_(b1).add_(g * (1.0 - b1))
        opt.nu.mul_(b2).add_((g * g) * (1.0 - b2))
        bc1, bc2 = bias
        upd = (opt.mu / bc1) / ((opt.nu / bc2).sqrt_().add_(ADAM_EPS))
        if live is not None:
            opt.mu.mul_(live)
            opt.nu.mul_(live)
    upd = upd * factors.live_bifpn
    if live is not None:
        upd = upd * live
    return upd.neg_()


@torch.no_grad()
def flat_ema(ema_vec: torch.Tensor, new_vec: torch.Tensor, updates: int,
             decay: float, tau: float) -> None:
    """The EMA ramp on one flat vector, in place (`ema.py::ModelEMA.update`);
    `updates` is the counter after this step's increment."""
    ema_step(ema_vec, new_vec, *ema_decay(updates, decay, tau))


@torch.no_grad()
def ema_step(ema_vec: torch.Tensor, new_vec: torch.Tensor, d, one_minus_d) -> None:
    """ema ← d · ema + (1 − d) · new, in place; d and 1 − d floats or 0-dim
    tensors."""
    ema_vec.mul_(d).add_(new_vec * one_minus_d)


class FlatOptimizer:
    """`optim.py::Optimizer` on the flat parameter vector `flat` (whose
    views the model's parameters are).  `names` and the per-parameter
    views of its state (`trace`, or `mu` / `nu` and `count`) read as the
    per-tensor optimizer's do."""

    def __init__(self, cfg: TrainConfig, named_params: Sequence[Tuple[str, torch.Tensor]],
                 flat: torch.Tensor, train_bifpn: bool = True):
        if cfg.optimizer_type not in ("sgd", "adam"):
            raise ValueError(cfg.optimizer_type)
        self.cfg = cfg
        self.flat = flat
        self.factors = build_factors(named_params, train_bifpn, flat.device)
        self.names = self.factors.layout.names
        self.opt = init_flat_opt(cfg, flat.numel(), flat.device)
        self.lr = scalar(flat.device)
        self.bias = None  # Adam's bias corrections
        if cfg.optimizer_type == "adam":
            self.bias = (scalar(flat.device), scalar(flat.device))
        views = self.factors.layout.views
        if cfg.optimizer_type == "sgd":
            self.trace = views(self.opt.trace)
        else:
            self.mu, self.nu = views(self.opt.mu), views(self.opt.nu)

    @property
    def count(self) -> int:
        return self.opt.count

    def state(self) -> Dict:
        if self.cfg.optimizer_type == "sgd":
            return {"trace": dict(zip(self.names, self.trace))}
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state(self, state: Dict) -> None:
        if self.cfg.optimizer_type == "sgd":
            slots = {"trace": self.trace}
        else:
            self.opt = self.opt._replace(count=int(state["count"]))
            slots = {"mu": self.mu, "nu": self.nu}
        for key, views in slots.items():
            for name, t in zip(self.names, views):
                t.copy_(state[key][name])

    def step(self, g: torch.Tensor, lr: float, freeze_backbone: bool = False) -> None:
        """One step from the flat gradient `g` (float32, `flat`'s layout)."""
        self.advance(lr)
        self.apply(g, freeze_backbone)

    def advance(self, lr: float) -> None:
        """A step's host half: the learning rate and, for Adam, the count
        and its bias corrections, written to the device scalars."""
        self.lr.fill_(lr)
        if self.bias is not None:
            self.opt = self.opt._replace(count=self.opt.count + 1)
            for t, v in zip(self.bias, adam_bias(self.opt.count, self.cfg.momentum)):
                t.fill_(v)

    @torch.no_grad()
    def apply(self, g: torch.Tensor, freeze_backbone: bool = False) -> None:
        """A step's kernels, after `advance`: they read the scalars on the
        device and change no host state, so they can be captured."""
        upd = flat_updates(self.cfg, self.factors, g, self.flat, self.opt,
                           freeze_backbone, self.bias)
        self.flat.add_(upd.mul_(self.lr))


class FlatEMA:
    """`ema.py::ModelEMA` over the flat parameter and statistics vectors.
    `variables` maps the model's floating state_dict names, in its order, to
    views of the two EMA vectors."""

    def __init__(self, sd_names: Sequence[str], params: Tuple[FlatLayout, torch.Tensor],
                 stats: Tuple[FlatLayout, torch.Tensor], updates: int = 0):
        self.updates = updates
        self.live = (params[1], stats[1])
        self.vecs = (params[1].clone(), stats[1].clone())
        self.d, self.one_minus_d = scalar(params[1].device), scalar(params[1].device)
        where = {}
        for (layout, _), vec in zip((params, stats), self.vecs):
            where.update(zip(layout.names, layout.views(vec)))
        self.variables: Dict[str, torch.Tensor] = {k: where[k] for k in sd_names}

    def update(self, model=None, decay: float = 0.9999, tau: float = 2000.0) -> None:
        """One EMA step from the live vectors (`model` is not read: its
        state is the vectors)."""
        self.advance(decay, tau)
        self.apply()

    def advance(self, decay: float = 0.9999, tau: float = 2000.0) -> None:
        """A step's host half: the update count, and d(u) and 1 − d(u)
        written to the device scalars."""
        self.updates += 1
        for t, v in zip((self.d, self.one_minus_d), ema_decay(self.updates, decay, tau)):
            t.fill_(v)

    @torch.no_grad()
    def apply(self) -> None:
        """A step's kernels, after `advance` (capturable, as
        `FlatOptimizer.apply`)."""
        for ema, live in zip(self.vecs, self.live):
            ema_step(ema, live, self.d, self.one_minus_d)

    @torch.no_grad()
    def load(self, variables: Dict[str, torch.Tensor], updates: int) -> None:
        for k, v in self.variables.items():
            v.copy_(variables[k])
        self.updates = int(updates)
