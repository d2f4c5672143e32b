"""Training traffic: the training CLI's loop with augmentation on the card
(`--device-aug`): each step draws a batch from `DeviceAugLoader` and runs
`Trainer.train_step` on it, epoch after epoch over a staged dataset.

Traffic parameters (`benchmark/traffic/<mix>.json`): `batch`,
`dataset_pairs` synthetic pairs of `image_hw` with `boxes_per_image`
objects, `mosaic_prob`, `mixup_prob`, `special_aug_ratio`,
`epochs_planned` (the schedule's length), `reference_steps` (set-up's
first steps, which the reference follows), `judged_step` (the range
[lo, hi] from which the seed draws the index of the window's step that is
judged; the window runs on until that step is done) and `trace_steps`.

As the CLI runs it: bfloat16 compute with TF32 allowed around it, the
shuffles folded into the weights (`--fold-shuffle`, its default), the
stem on kernel C wherever it applies, SGD-nesterov at the schedule's
epoch-0 learning rate, EMA on, the dataset staged at the input size and
resampled in bfloat16.  The weights are the start of training, made from
the seed.  The window's end-to-end numbers: `train_images_per_s` over all
of its steps and time (ending in a synchronise), and `peak_mem_gib` over
set-up and window.

`correct` (`benchlib/judge_train.py`): set-up's first steps against the
reference's from the same weights, and the judged window step against
the reference's step from the program's state just before it, copied to
the host in one transfer between two steps (outside the step, so that
neither the step's time nor the peak of device memory holds it).
"""

from __future__ import annotations

import gc
import resource
import shutil
import tempfile
import time

import numpy as np
import torch

from benchlib import judge_train, synth, weights, yardstick
from benchlib import trace as tracing
from benchlib.harness import Context, Outcome, card_of, sync
from benchlib.spec import sizes_of
from reference import augment as ref_aug
from reference.model import ReferenceYolo, Sizes, fold_spec, state_names, unfold
from reference.precision import ieee, rounding
from reference.train import MOMENTUM, ReferenceTrainer

MAX_BOXES = 64
PREFIXES = ("", "ema.", "trace.")
NBS, INIT_LR, LR_MIN_LIMIT, LR_MAX_LIMIT = 64, 1e-2, 5e-4, 5e-2


def epoch0_lr(batch: int) -> float:
    """The recipe's SGD learning rate at epoch 0 (`train_mul.py:240-244`
    and the cosine schedule's warm-up start, `nets/yolo_training.py:
    500-536`): the batch-scaled lr, clamped, times 0.1."""
    lr = min(max(batch / NBS * INIT_LR, LR_MIN_LIMIT), LR_MAX_LIMIT)
    return max(0.1 * lr, 1e-6)




class PortRun:
    """The system under test: the folded train graph, its trainer and the
    loader, fed batch after batch across epochs."""

    def __init__(self, cfg_json, tr, lines, seed, dev):
        from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
        from dcfa_yolo_tpu_torch.data.device_aug import DeviceAugLoader
        from dcfa_yolo_tpu_torch.models.reparam import apply_shuffle_spec, shuffle_fold_spec
        from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo
        from dcfa_yolo_tpu_torch.train.trainer import Trainer

        sizes = sizes_of(cfg_json)
        self.sd0 = weights.make_state(state_names(sizes), seed, "training", dev)
        cfg = ModelConfig(num_classes=sizes.num_classes, phi=sizes.phi,
                          input_shape=sizes.input_hw, reg_max=sizes.reg_max,
                          compute_dtype=cfg_json["compute_dtype"])
        model = DCFAYolo(cfg, fold_shuffle=True)
        folded = apply_shuffle_spec(self.sd0, shuffle_fold_spec(self.sd0))
        model.load_state_dict(folded, strict=True)
        self.folded0 = {k: v.clone() for k, v in folded.items()}
        batch = int(tr["batch"])
        tc = TrainConfig(batch_size=batch, mosaic_prob=tr["mosaic_prob"],
                         mixup_prob=tr["mixup_prob"],
                         special_aug_ratio=tr["special_aug_ratio"],
                         unfreeze_epoch=int(tr["epochs_planned"]), max_boxes=MAX_BOXES)
        self.trainer = Trainer(model.to(dev), tc, device=dev)
        bf16 = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        self.loader = DeviceAugLoader(
            lines, sizes.input_hw, batch, train=True, max_boxes=MAX_BOXES,
            stage_hw=sizes.input_hw, mosaic=True, mosaic_prob=tr["mosaic_prob"],
            mixup=True, mixup_prob=tr["mixup_prob"],
            special_aug_ratio=tr["special_aug_ratio"],
            epoch_length=int(tr["epochs_planned"]), shuffle=True, seed=seed,
            resample_dtype=bf16 if dev.type == "cuda" else None, out_dtype=bf16,
            device=dev)
        self.lr = epoch0_lr(batch)
        self.epoch = 0
        self.loader.set_epoch(0)
        self.it = iter(self.loader)

    def next_batch(self):
        b = next(self.it, None)
        if b is None:
            self.epoch += 1
            self.loader.set_epoch(self.epoch)
            self.it = iter(self.loader)
            b = next(self.it)
        return b

    def step(self, batch):
        return self.trainer.train_step(batch, self.lr)

    def snapshot(self):
        """The trainer's state on the host, in one copy: the model's floating
        entries (parameters, BN statistics), `ema.`<entry> and
        `trace.`<parameter>; and the EMA's update count."""
        st = self.trainer.state
        live = {k: v for k, v in self.trainer.model.state_dict().items()
                if v.is_floating_point()}
        live.update({f"ema.{k}": v for k, v in st.ema.items()})
        live.update({f"trace.{k}": v for k, v in st.opt_state["trace"].items()})
        return host_copy(live), int(st.ema_updates)


def host_copy(tensors):
    """Float32 copies of `tensors` on the host, moved in one transfer."""
    names = list(tensors)
    flat = torch.cat([tensors[n].detach().reshape(-1).float() for n in names]).cpu()
    out, at = {}, 0
    for n in names:
        k = tensors[n].numel()
        out[n] = flat[at:at + k].view(tensors[n].shape)
        at += k
    return out


def split(snap):
    """A snapshot's (state, trace, ema) dictionaries."""
    state, trace, ema = {}, {}, {}
    for k, v in snap.items():
        if k.startswith("trace."):
            trace[k[6:]] = v
        elif k.startswith("ema."):
            ema[k[4:]] = v
        else:
            state[k] = v
    return state, trace, ema


def step_record(before, after, loss, images, targets):
    """What one step did, from the state before and after it: the gradient
    as the optimizer got it (trace_after − momentum · trace_before) and the
    change of every state entry (the EMA's as `ema.`<entry>)."""
    sb, tb, eb = split(before)
    sa, ta, ea = split(after)
    change = {k: sa[k] - sb[k] for k in sb}
    change.update({f"ema.{k}": ea[k] - eb[k] for k in eb})
    return {"losses": [loss], "images": [images], "targets": [targets],
            "grad": {k: ta[k] - MOMENTUM * tb[k] for k in tb}, "change": change}


def judged_step(tr, seed: int) -> int:
    """The index of the window's step that is judged, drawn from the seed
    within the traffic's `judged_step` range."""
    lo, hi = (int(x) for x in tr["judged_step"])
    return int(np.random.Generator(np.random.PCG64(seed + 2)).integers(lo, hi + 1))


def run(ctx: Context) -> Outcome:
    cell, tr, dev = ctx.cell, ctx.cell.traffic, ctx.device
    # the CLI's bf16 setting: TF32 allowed for the float32 ops around the graph
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    sizes = sizes_of(cell.config)
    work = tempfile.mkdtemp(prefix="bench_train")
    try:
        t = time.perf_counter()
        lines = synth.write_dataset(work, int(tr["dataset_pairs"]), tuple(tr["image_hw"]),
                                    ctx.seed, tr["boxes_per_image"])
        t_data = time.perf_counter() - t
        t = time.perf_counter()
        port = PortRun(cell.config, tr, lines, ctx.seed, dev)
        t_build = time.perf_counter() - t
        t = time.perf_counter()
        batch, n_setup = int(tr["batch"]), int(tr["reference_steps"])
        # set-up: the first steps, which the reference follows
        setup = {"losses": [], "images": [], "targets": []}
        start, _ = port.snapshot()
        for s in range(n_setup):
            b = port.next_batch()
            setup["images"].append((b.rgb.cpu(), b.nir.cpu()))
            setup["targets"].append((b.gt_boxes.cpu(), b.gt_labels.cpu(), b.gt_mask.cpu()))
            lb = port.step(b)
            setup["losses"].append(float(lb.total))
            if s == 0:
                setup["grad"] = host_copy(port.trainer.state.opt_state["trace"])
        end, _ = port.snapshot()
        setup["change"] = {k: end[k] - start[k] for k in start if not k.startswith("trace.")}
        sync(dev)
        ctx.say(f"[train] set-up: dataset files {t_data:.3f} s, model, trainer and "
                f"staged loader {t_build:.3f} s, first {n_setup} steps "
                f"{time.perf_counter() - t:.3f} s, process start to here "
                f"{time.perf_counter() - ctx.t0:.3f} s")

        # ---- the measured window; one step in it is kept for the reference ----
        judged = judged_step(tr, ctx.seed)
        gen2 = gc.get_stats()[2]["collections"]
        use0 = resource.getrusage(resource.RUSAGE_SELF)
        t_start = time.perf_counter()
        setup_s = t_start - ctx.t0
        steps, marks = 0, [t_start]
        while steps <= judged or time.perf_counter() - t_start < ctx.seconds:
            b = port.next_batch()
            if steps == judged:
                images = (b.rgb.cpu(), b.nir.cpu())
                targets = (b.gt_boxes.cpu(), b.gt_labels.cpu(), b.gt_mask.cpu())
                before, updates = port.snapshot()
                loss = float(port.step(b).total)
                after, _ = port.snapshot()
            else:
                port.step(b)
            steps += 1
            marks.append(time.perf_counter())
        sync(dev)
        window_s = time.perf_counter() - t_start
        use1 = resource.getrusage(resource.RUSAGE_SELF)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        e2e = {"train_images_per_s": steps * batch / window_s,
               "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        ctx.say(f"[train] {cell.name}: {steps} steps of {batch} in {window_s:.3f} s "
                f"({e2e['train_images_per_s']:.3f} images/s), epoch {port.epoch}, "
                f"train stem {port.trainer.train_stem}, peak {peak} bytes, "
                f"set-up {setup_s:.3f} s")
        cpu = use1.ru_utime + use1.ru_stime - use0.ru_utime - use0.ru_stime
        ctx.say("[train] host time a step: " + step_times(marks)
                + f"; in the window: gen-2 collections "
                  f"{gc.get_stats()[2]['collections'] - gen2}, the process's CPU time "
                  f"{cpu:.3f} s ({cpu / window_s * 100:.1f}% of the wall), involuntary "
                  f"context switches {use1.ru_nivcsw - use0.ru_nivcsw}")

        trace = None
        if ctx.trace:
            from torch.profiler import record_function

            def one(_):
                with record_function("augment"):
                    b = port.next_batch()
                with record_function("train_step"):
                    port.step(b)

            trace = tracing.record(one, int(tr["trace_steps"]), "step", dev)
        del port
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # ---- the reference, after the window ----
        t_ref = time.perf_counter()
        fold = fold_spec(dict(state_names(sizes)))
        setup["grad"] = unfold(setup["grad"], fold)
        setup["change"] = unfold(setup["change"], fold)
        before = unfold(before, fold, PREFIXES)
        window = step_record(before, unfold(after, fold, PREFIXES), loss, images, targets)
        ref = Reference(sizes, tr, lines, ctx.seed, dev)
        ref_setup, _ = ref.steps("float32", n_setup)
        ref_window = ref.window_step("float32", *split(before), updates, n_setup + judged)
        ctx.say(f"[train] reference: {n_setup} set-up steps and window step {judged} in "
                f"{time.perf_counter() - t_ref:.3f} s; losses port "
                f"{setup['losses'] + window['losses']} reference "
                f"{ref_setup['losses'] + ref_window['losses']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    got = judge_train.judge({"setup": setup, "window": window},
                            {"setup": ref_setup, "window": ref_window})
    ctx.say("[train] reported, not compared: " + ", ".join(
        f"{k} {v!r}" + (f" ({leaf})" if leaf else "") for k, (v, leaf) in got.items()
        if k not in judge_train.COMPARED))
    lim = cell.limits
    checks = {k: (float(got[k][0]), float(lim[k])) for k in judge_train.COMPARED}
    layer = {"rate_items_per_s": e2e["train_images_per_s"], "batch": batch,
             "input_hw": sizes.input_hw,
             "flops_per_item": yardstick.forward_flops(sizes, batch,
                                                       train=True) / batch}
    return Outcome(e2e, steps, 0, checks, peak, [card_of(dev)], layer, trace)


def step_times(marks) -> str:
    """The window's host time a step: median, 90th percentile and largest,
    and the steps over 1.5 times the median with their share of the
    window."""
    d = np.diff(np.asarray(marks)) * 1e3
    med = float(np.median(d))
    slow = d[d > 1.5 * med]
    return (f"median {med:.3f} ms, p90 {float(np.percentile(d, 90)):.3f} ms, "
            f"largest {float(d.max()):.3f} ms, {len(slow)} steps over 1.5x the median "
            f"({float(slow.sum()) / float(d.sum()) * 100:.2f}% of the window)")


class Reference:
    """The plain reference of the cell's training: the dataset staged again
    from its files, each batch worked out again from the loader's seed, and
    reference trainers at a given precision (at fp8 the precision control,
    at bfloat16 the witness of that rounding alone)."""

    def __init__(self, sizes: Sizes, tr, lines, seed: int, dev):
        self.sizes, self.tr, self.seed, self.dev = sizes, tr, seed, dev
        self.batch = int(tr["batch"])
        with ieee():
            self.ds = ref_aug.stage_pairs(lines, sizes.input_hw, MAX_BOXES)
        self.ds_dev = tuple(torch.from_numpy(a).to(dev)
                            for a in (self.ds.images, self.ds.boxes, self.ds.nbox))
        self.sampler = ref_aug.ParamSampler(
            self.ds, sizes.input_hw, mosaic=True, mosaic_prob=tr["mosaic_prob"], mixup=True,
            mixup_prob=tr["mixup_prob"], special_aug_ratio=tr["special_aug_ratio"],
            epoch_length=int(tr["epochs_planned"]))
        self.augment = ref_aug.make_augment(sizes.input_hw, MAX_BOXES)
        self.lr = epoch0_lr(self.batch)

    def batch_at(self, index: int, precision: str):
        """The run's batch number `index` (epochs of whole batches, each
        shuffled from seed + epoch): rgb, nir, boxes, labels, mask."""
        epoch, at = divmod(index, len(self.ds.images) // self.batch)
        for i, (_, params) in enumerate(ref_aug.batches(self.ds, self.sampler, self.batch,
                                                        self.seed, epoch)):
            if i == at:
                break
        with rounding(precision):  # pixels and boxes alike
            return ref_aug.run_augment(self.augment, self.ds_dev, params, self.dev)

    def trainer(self, precision: str) -> ReferenceTrainer:
        """A reference trainer at the seed's weights."""
        model = ReferenceYolo(self.sizes, precision)
        model.load_state_dict(weights.make_state(state_names(self.sizes), self.seed,
                                                 "training", self.dev), strict=True)
        return ReferenceTrainer(model, self.dev)

    def _step(self, rt, index, precision, out):
        rgb, nir, boxes, labels, mask = self.batch_at(index, precision)
        out["images"].append((rgb.cpu(), nir.cpu()))
        out["targets"].append((boxes.cpu(), labels.cpu(), mask.cpu()))
        out["losses"].append(rt.step(rgb, nir, boxes, labels, mask, self.lr)[0])

    def steps(self, precision: str, n: int):
        """The first `n` steps from the seed's weights: a `judge_train`
        record (the first gradient, the change over the steps) and the
        trainer where they left it."""
        with ieee():
            rt = self.trainer(precision)
            start = rt.state()
            out = {"losses": [], "images": [], "targets": []}
            for s in range(n):
                self._step(rt, s, precision, out)
                if s == 0:
                    out["grad"] = {k: v.detach().cpu().clone() for k, v in rt.trace.items()}
            out["change"] = {k: (v - start[k]).cpu() for k, v in rt.state().items()}
        return out, rt

    def window_step(self, precision: str, state, trace, ema, updates: int, index: int):
        """One step on batch `index` from the given point of training (the
        reference's layout): a `judge_train` record."""
        on = lambda d: {k: v.to(self.dev) for k, v in d.items()}  # noqa: E731
        with ieee():
            rt = self.trainer(precision)
            rt.load(on(state), on(trace), on(ema), updates)
            before = rt.state()
            trace0 = {k: v.clone() for k, v in rt.trace.items()}
            out = {"losses": [], "images": [], "targets": []}
            self._step(rt, index, precision, out)
            out["grad"] = {k: (rt.trace[k] - MOMENTUM * trace0[k]).cpu() for k in trace0}
            out["change"] = {k: (v - before[k]).cpu() for k, v in rt.state().items()}
        return out


def point(rt: ReferenceTrainer):
    """A reference trainer's point of training: (state, trace, ema,
    updates), as `Reference.window_step` takes it."""
    st = rt.state()
    return ({k: v for k, v in st.items() if not k.startswith("ema.")},
            {k: v.clone() for k, v in rt.trace.items()},
            {k[4:]: v for k, v in st.items() if k.startswith("ema.")}, rt.updates)
