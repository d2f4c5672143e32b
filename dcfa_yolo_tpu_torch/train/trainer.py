"""The train step (`dcfa_yolo_tpu/train/trainer.py:43-52, 81-240, 243-554`;
reference `fit_one_epoch`, `utils/utils_fit_mul.py:8-121`), on one device or
data-parallel over a torch process group.

One step: train-mode forward (BatchNorm on the batch, running statistics
updated), loss, backward, optimizer, EMA.  `eval_step` computes the loss on
the EMA weights in eval mode.  The step is split into `forward`, `loss`,
`backward` and `update` so a caller can time its stages.  `state` reads and
restores the whole training state (exact resume, `train.py:362-384`).

The optimizer and EMA run on flat vectors by default (`flat_tail`,
`train/flat_opt.py`, as the JAX fused step does, `trainer.py:256`): the
parameters and the BN statistics are views into two float32 vectors and
the gradient is raveled into one.  `flat_tail=False` keeps the per-tensor
path (`train/optim.py`, `train/ema.py`), bit-equal on the CPU.

Data parallel (`group`, one process a rank, each with its slice of the
global batch), in the JAX Trainer's two step modes:
- `fused` (`make_train_step` over a sharded batch): the BatchNorm moments
  (kernel C's sums included) and the loss's normaliser are the global
  batch's, each rank backpropagates its part of the global loss, and the
  flat gradient and the loss terms are all-reduced with SUM: the gradient of
  the global-batch loss.
- `split` (`make_split_train_step`, `trainer.py:162-240`): local BN and a
  local loss; the gradient, the loss terms and the BN running statistics are
  averaged over the ranks (`:203-206`) before the one update.
- `auto`: split on the CPU with more than one rank, else fused
  (`trainer.py:275-277`).
After every step the replicas are equal.  No DDP wrapper: it would broadcast
rank 0's BN statistics and average per-rank-normalised losses.

On one CUDA device with the flat tail (`capture="auto"`), the step is one
CUDA graph: its shapes are static and it makes no host synchronisation, so
after two eager steps of a key (the batch's shapes and dtypes, the freeze
phase, the stem graph) the third call captures the device work (forward,
loss, backward, ravel, optimizer and EMA: `_capture`) and replays it,
and every later call of the key copies its batch into the graph's inputs,
writes the step's scalars (`flat_opt.py`) and replays.  A new key drops
the graph and warms up again.  The CPU, a process group and the per-tensor
tail run the eager step.
"""

from __future__ import annotations

import copy
import warnings
from typing import Dict, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from dcfa_yolo_tpu_torch.config import TrainConfig
from dcfa_yolo_tpu_torch.device import resolve_device
from dcfa_yolo_tpu_torch.models.yolo import _DTYPES
from dcfa_yolo_tpu_torch.ops import cuda_bn_train, cuda_stem_train
from dcfa_yolo_tpu_torch.parallel.mesh import broadcast_state, reduce_in_place, world_size
from dcfa_yolo_tpu_torch.train.ema import ModelEMA
from dcfa_yolo_tpu_torch.train.flat_opt import (FlatAdam, FlatEMA, FlatLayout,
                                                FlatOptimizer, FlatSGD, flatten_into)
from dcfa_yolo_tpu_torch.train.loss import LossBreakdown, YoloLoss
from dcfa_yolo_tpu_torch.train.optim import Optimizer
from dcfa_yolo_tpu_torch.utils.profiling import count, span

STEP_MODES = ("auto", "fused", "split")
CAPTURE_MODES = ("auto", "off")
WARMUP_STEPS = 2  # eager steps of a key before its step is captured
# the kernels' counters a captured step holds, and adds at each replay
HELD_COUNTERS = ((cuda_stem_train, "LAUNCHES"), (cuda_stem_train, "LAUNCHES_F32"),
                 (cuda_bn_train, "LAUNCHES"))


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


class FlatTrainState(NamedTuple):
    """The flat tail's state (`trainer.py:43-52`): the live vectors
    themselves, no copies.  `state` gives the same as per-name dicts."""

    flat_params: torch.Tensor
    flat_stats: torch.Tensor
    opt: Union[FlatSGD, FlatAdam]
    ema_p: torch.Tensor
    ema_s: torch.Tensor
    ema_updates: int


def graph_route(capture: str, device: torch.device, group, flat_tail: bool) -> bool:
    """Whether a trainer replays its step from a CUDA graph: `capture`
    'auto' on a CUDA device, with no process group (the data-parallel step
    keeps its all-reduces and kernel C's host check) and the flat tail
    (whose per-step values live on the device)."""
    return capture == "auto" and device.type == "cuda" and group is None and flat_tail


class _StepGraph(NamedTuple):
    """One captured step: its key, the graph, the static inputs it reads
    (the capturing call's batch), its static outputs (the stacked loss
    terms and the flat gradient), what it adds to each of `HELD_COUNTERS`
    (kernel C's launches, all and float32, and kernel D's launches) and
    the bytes its private memory pool holds."""

    key: tuple
    graph: "torch.cuda.CUDAGraph"
    inputs: Batch
    terms: torch.Tensor
    grad: torch.Tensor
    launches: Tuple[int, ...]
    pool_bytes: int


def pool_bytes(graph: "torch.cuda.CUDAGraph") -> int:
    """Bytes of the device memory segments held by `graph`'s private
    pool."""
    pool = tuple(graph.pool())
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == pool)


class Trainer:
    """Owns the model in train mode, the optimizer state and the EMA.

    `train_stem` is the stem graph the steps run ('kernel' or 'plain').
    When 'auto' leaves a CUDA device on the plain graph (kernel C needs an
    sm_90 card, 16 stem channels and an even input shape), the trainer says
    so once, with a warning.  `ema_updates` starts the EMA's ramp (a resumed
    or late-started run); `train_bifpn=False` leaves the BiFPN fusion
    weights untrained, as the reference does (`--frozen-bifpn`).

    `group`: the process group of data-parallel training (None: one
    process), with `step_mode` 'auto', 'fused' or 'split' (module
    docstring); every rank builds its trainer from the same model and
    feeds it its slice of each global batch (`parallel/mesh.py::
    shard_batch`).  The replicas start from rank 0's weights.
    `criterion`: a loss with YoloLoss's call and a `group` attribute (the
    trainer sets it); default `YoloLoss`.
    `capture`: 'auto' replays the step from a CUDA graph wherever it can
    (module docstring: a CUDA device, no group, the flat tail), 'off' runs
    every step eagerly."""

    def __init__(self, model, train_cfg: TrainConfig = TrainConfig(),
                 device="cuda", ema_updates: int = 0, train_bifpn: bool = True,
                 step_mode: str = "auto", group=None, flat_tail: bool = True,
                 criterion=None, capture: str = "auto"):
        if step_mode not in STEP_MODES:
            raise ValueError(f"step_mode must be one of {STEP_MODES}, got {step_mode!r}")
        if capture not in CAPTURE_MODES:
            raise ValueError(f"capture must be one of {CAPTURE_MODES}, got {capture!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.cfg = model.cfg
        self.group, self.world = group, world_size(group)
        if step_mode == "auto":
            step_mode = "split" if self.device.type == "cpu" and self.world > 1 else "fused"
        self.step_mode = step_mode
        self.train_stem = model.train_stem_route()
        if (self.train_stem == "plain" and self.device.type == "cuda"
                and self.cfg.train_stem_backend == "auto"):
            warnings.warn(
                f"train stem 'auto' runs the plain graph on {self.device} "
                f"(input {self.cfg.input_shape}): no train-stem kernel is "
                "launched", stacklevel=2)
        self.tc = train_cfg
        # the group the forward's moments and the loss's normaliser span
        shared = group if step_mode == "fused" else None
        self.criterion = (YoloLoss(self.cfg, train_cfg, self.device) if criterion is None
                          else criterion)
        self.criterion.group = shared
        self._eval_model = copy.deepcopy(self.model).eval()
        for p in self._eval_model.parameters():
            p.requires_grad_(False)
        self.model.set_process_group(shared)
        broadcast_state(self.model, group)
        self._named = list(self.model.named_parameters())
        buffers = list(self.model.named_buffers())
        self._buffers = [b for _, b in buffers]
        # where each parameter (statistic) sits in the flat gradient (the
        # all-reduced statistics); with the flat tail, in the live vectors
        self._p_layout, self._s_layout = FlatLayout(self._named), FlatLayout(buffers)
        self.flat_tail = flat_tail
        self.flat_params = self.flat_stats = None
        if flat_tail:
            self.flat_params = flatten_into(self._named)
            self.flat_stats = flatten_into(buffers)
            self.optimizer = FlatOptimizer(train_cfg, self._named, self.flat_params,
                                           train_bifpn)
            self.ema = FlatEMA([k for k, v in self.model.state_dict().items()
                                if v.is_floating_point()],
                               (self._p_layout, self.flat_params),
                               (self._s_layout, self.flat_stats), ema_updates)
        else:
            self.optimizer = Optimizer(train_cfg, self._named, train_bifpn)
            self.ema = ModelEMA(self.model, ema_updates)
        self.steps = 0  # steps taken: the request id of their spans
        self.graph_route = graph_route(capture, self.device, group, flat_tail)
        self._graph = None        # the captured step (`_StepGraph`) of the last key
        self._warm = (None, 0)    # (key, its eager steps in a row)
        self._counts = {"captures": 0, "replays": 0, "eager": 0}

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
        # contiguous: a conv's weight gradient may come channels_last, and
        # the clip's norm then reduces it in memory order
        return [torch.zeros_like(p) if g is None else g.contiguous()
                for g, p in zip(grads, params)]

    def reduce(self, grads: Sequence[torch.Tensor], terms: torch.Tensor):
        """Over the group: the flat gradient and the stacked loss terms,
        summed (fused) or averaged with the BN statistics (split), in one
        all-reduce.  Returns (flat gradient, terms); no group: the raveled
        gradient and the terms."""
        g = self._p_layout.ravel(grads)
        if self.group is None:
            return g, terms
        parts = [g, terms.float()]
        if self.step_mode == "split":
            parts.append(self._s_layout.ravel(self._buffers))
        buf = reduce_in_place(torch.cat(parts), self.group)
        n, k = g.numel(), terms.numel()
        if self.step_mode == "split":
            buf.div_(self.world)
            with torch.no_grad():
                for b, v in zip(self._buffers, self._s_layout.views(buf[n + k:])):
                    b.copy_(v)
        return buf[:n], buf[n:n + k]

    def update(self, grads: Union[torch.Tensor, Sequence[torch.Tensor]], lr: float,
               freeze_backbone: bool = False) -> None:
        """The optimizer and EMA step from the gradients (per parameter, or
        one flat vector in the parameters' order)."""
        if self.flat_tail and not isinstance(grads, torch.Tensor):
            grads = self._p_layout.ravel(grads)
        elif not self.flat_tail and isinstance(grads, torch.Tensor):
            grads = self._p_layout.views(grads)
        self.optimizer.step(grads, lr, freeze_backbone)
        self.ema.update(self.model, self.tc.ema_decay, self.tc.ema_tau)

    # ------------------------------------------------------------------
    def train_step(self, batch: Batch, lr: float, freeze_backbone: bool = False
                   ) -> LossBreakdown:
        """One step.  Returns the loss terms as device scalars (no host
        synchronisation), the caller's own (a later step never overwrites
        them); over a group, the global batch's (fused: the sum of the
        ranks' parts; split: the ranks' mean).  On the captured route the
        batch passed to the call that captures the step becomes the graph's
        input, which every later step of its key overwrites with its own
        batch: a caller that reads that batch after the step must copy it
        first."""
        return self._step(batch, lr, freeze_backbone, False)[0]

    def step_with_grad(self, batch: Batch, lr: float, freeze_backbone: bool = False):
        """`train_step`, also returning the flat gradient the update took
        (over a group, the reduced one).  The step and each stage are spans
        (`utils/profiling.py::span`); on the captured route `trainer.capture`
        holds the stages of the call that captures, and `trainer.replay`
        each replay."""
        return self._step(batch, lr, freeze_backbone, True)

    def graph_stats(self) -> Dict[str, int]:
        """Steps so far by route: graphs captured, replays, eager steps."""
        return dict(self._counts)

    def _step(self, batch: Batch, lr: float, freeze_backbone: bool, want_grad: bool):
        self.steps += 1
        with span("trainer.step", request=self.steps):
            g = self._graph
            if self.graph_route:
                key = (tuple((tuple(t.shape), t.dtype) for t in batch),
                       bool(freeze_backbone), self.train_stem)
                if g is not None and g.key != key:
                    # drop the graph, its inputs and its memory pool
                    self._graph = g = None
                if g is None:
                    n = self._warm[1] + 1 if self._warm[0] == key else 1
                    if n > WARMUP_STEPS:
                        with span("trainer.capture"):
                            g = self._graph = self._capture(key, batch, freeze_backbone)
                    else:
                        self._warm = (key, n)
            if g is None:
                self._counts["eager"] += 1
                terms, grad = self._stages(
                    batch, lambda flat: self.update(flat, lr, freeze_backbone))
                return LossBreakdown(*terms.unbind(0)), grad
            with span("trainer.replay"):
                return self._replay(g, batch, lr, want_grad)

    def _stages(self, batch: Batch, update):
        """Forward, loss, backward, reduce and `update(flat gradient)`, each
        in its span: (stacked loss terms, flat gradient)."""
        with span("trainer.forward"):
            feats = self.forward(batch)
        with span("trainer.loss"):
            lb = self.loss(feats, batch)
        with span("trainer.backward"):
            grads = self.backward(lb.total)
        with span("trainer.reduce"):
            g, terms = self.reduce(grads, torch.stack([t.detach() for t in lb]))
        with span("trainer.update"):
            update(g)
        return terms, g

    def _capture(self, key, batch: Batch, freeze_backbone: bool) -> _StepGraph:
        """Capture the step's device work on `batch` into a new graph with a
        memory pool of its own: the stages, with the optimizer's and the
        EMA's kernels (`apply`) as the update; their host halves (`advance`)
        run before each replay.  A capture records and runs nothing, so no
        state moves; the kernels' counters (`HELD_COUNTERS`) are put back
        (a replay adds what the graph holds).  A capture that fails raises:
        nothing falls back to the eager step.

        cuBLAS keeps a workspace (and cuBLASLt another) for each stream it
        runs on, two 32 MiB blocks with torch 2.11 on the H100: the capture
        stream's would sit beside the current stream's at the capture's
        peak.  So the workspaces are dropped before the capture, which
        allocates its own in the graph's pool, and after it: the graph keeps
        that memory, and the current stream allocates its own again at its
        next product."""
        def update(g):
            self.optimizer.apply(g, freeze_backbone)
            self.ema.apply()

        before = tuple(getattr(m, name) for m, name in HELD_COUNTERS)
        graph = torch.cuda.CUDAGraph()
        torch._C._cuda_clearCublasWorkspaces()
        try:
            with torch.cuda.graph(graph):
                terms, g = self._stages(batch, update)
        finally:
            held = tuple(getattr(m, name) - b for (m, name), b in zip(HELD_COUNTERS, before))
            for (m, name), b in zip(HELD_COUNTERS, before):
                setattr(m, name, b)
            torch._C._cuda_clearCublasWorkspaces()
        self._counts["captures"] += 1
        return _StepGraph(key, graph, batch, terms, g, held, pool_bytes(graph))

    def _replay(self, g: _StepGraph, batch: Batch, lr: float, want_grad: bool):
        """Copy `batch` into the graph's inputs, write the step's scalars,
        replay, and return copies of the outputs.  While a profiler
        records, the counter `trainer.graph_pool_bytes` holds the graph's
        pool size."""
        count("trainer.graph_pool_bytes", g.pool_bytes, total=True)
        for dst, src in zip(g.inputs, batch):
            if dst is not src:
                dst.copy_(src)
        self.optimizer.advance(lr)
        self.ema.advance(self.tc.ema_decay, self.tc.ema_tau)
        if g.launches[1]:
            cuda_stem_train.order_f32(torch.cuda.current_stream(self.device))
        g.graph.replay()
        for (m, name), n in zip(HELD_COUNTERS, g.launches):
            setattr(m, name, getattr(m, name) + n)
        self._counts["replays"] += 1
        return (LossBreakdown(*g.terms.clone().unbind(0)),
                g.grad.clone() if want_grad else None)

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> LossBreakdown:
        """Validation loss on the EMA weights, eval-mode BN
        (`make_eval_step`, `trainer.py:230-240`); over a group, the global
        batch's (fused: the global normaliser; split: the ranks' mean,
        `:418-440`)."""
        self._eval_model.load_state_dict(self.ema.variables)
        out = self._eval_model(batch.rgb, batch.nir)
        lb = self.criterion(out.feats, batch.gt_boxes, batch.gt_labels,
                            batch.gt_mask)
        if self.group is None:
            return lb
        terms = reduce_in_place(torch.stack(list(lb)).float(), self.group)
        if self.step_mode == "split":
            terms.div_(self.world)
        return LossBreakdown(*terms.unbind(0))

    # ------------------------------------------------------------------
    @property
    def state(self) -> TrainState:
        sd = self.model.state_dict()
        params = {n: p.detach() for n, p in self._named}
        stats = {k: v for k, v in sd.items() if k not in params}
        return TrainState(params, stats, self.optimizer.state(),
                          self.ema.variables, self.ema.updates)

    @state.setter
    def state(self, st: TrainState) -> None:
        """Copy a saved state into the live model, optimizer and EMA."""
        params = dict(self._named)
        buffers = dict(self.model.named_buffers())
        for have, got, what in ((params, st.params, "params"),
                                (buffers, st.batch_stats, "batch_stats")):
            if set(have) != set(got):
                raise KeyError(f"{what} do not match the model: missing "
                               f"{sorted(set(have) - set(got))[:3]}, unexpected "
                               f"{sorted(set(got) - set(have))[:3]}")
            with torch.no_grad():
                for name, t in have.items():
                    t.copy_(got[name])
        self.optimizer.load_state(st.opt_state)
        self.ema.load(st.ema, st.ema_updates)

    @property
    def flat_state(self) -> FlatTrainState:
        """The flat tail's vectors (`flat_tail=True` only)."""
        if not self.flat_tail:
            raise ValueError("the per-tensor tail (flat_tail=False) has no flat state")
        return FlatTrainState(self.flat_params, self.flat_stats, self.optimizer.opt,
                              *self.ema.vecs, self.ema.updates)

    def ema_variables(self) -> Dict[str, torch.Tensor]:
        """EMA of the parameters and the BN running statistics, by
        state_dict name."""
        return self.ema.variables

    def raw_variables(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.model.state_dict().items()}
