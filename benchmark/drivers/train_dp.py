"""Data-parallel training traffic: the training CLI's `--distributed` run
with augmentation on the card, one process a rank and a card each: every
rank stages the dataset, draws the global batch's parameters and augments
its own rows (`DeviceAugLoader(rank=, world=)`), and `Trainer(group=,
step_mode=)` takes the fused step (BN moments, kernel C's sums and the
loss's normaliser over the global batch, the flat gradient all-reduced).

Traffic parameters: those of `drivers/train.py`, where `batch` is the
global batch, and `ranks` (the world) and `step_mode`.

This process is rank 0 on card 0; it starts the other ranks as processes
of this file (`python3 train_dp.py --rank r ...`), on cards 1..W−1, joined
by NCCL (gloo on the CPU) over `tcp://localhost`, plus a gloo group for the
driver's own messages (the job, the window's stop flag, the batches and
replica digests gathered for the judge).  The ranks outlive a run, so that
`calibrate.py` runs many seeds on one world; they stop when this process
exits (and by themselves if it dies).

The window's end-to-end numbers: `train_images_per_s`, the global images
of its steps over rank 0's host clock (ending in a synchronise), and
`peak_mem_gib`, the largest rank's peak over set-up and window.  Every rank
traces the same steps; rank 0's trace is the cell's, and each rank's NCCL
kernel times go to `allreduce_ms.dp4` (`benchlib/links.py`).  `correct`:
rank 0 judges as `drivers/train.py` does, against the
reference's one-process float32 step on the global batch (the fused step's
BN moments and loss normaliser are the global batch's), with the batches
gathered from every rank; and `replica_gap`, the ranks whose state after
the judged step differs from rank 0's in any bit.
"""

from __future__ import annotations

import gc
import hashlib
import os
import shutil
import sys
import tempfile
import time

if __name__ == "__main__":  # a rank of its own: the benchmark's modules and the port
    _BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [_BENCH, os.path.dirname(_BENCH)]
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

import torch
import torch.distributed as dist

from benchlib import judge_train, ranks, synth, yardstick
from benchlib import trace as tracing
from benchlib.harness import Outcome, card_of, sync
from benchlib.ranks import Ranks
from benchlib.spec import sizes_of
from drivers.train import (MAX_BOXES, PREFIXES, PortRun, Reference, epoch0_lr, host_copy,
                           judged_step, split, step_record, step_times)
from reference.model import fold_spec, state_names, unfold


class DPPortRun(PortRun):
    """`drivers/train.py`'s system under test on one rank of a group: the
    trainer over the group in the traffic's step mode, the loader on the
    rank's rows of each global batch."""

    def __init__(self, cfg_json, tr, lines, seed, dev, group, rank, world):
        from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
        from dcfa_yolo_tpu_torch.data.device_aug import DeviceAugLoader
        from dcfa_yolo_tpu_torch.models.reparam import apply_shuffle_spec, shuffle_fold_spec
        from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo
        from dcfa_yolo_tpu_torch.train.trainer import Trainer

        from benchlib import weights

        sizes = sizes_of(cfg_json)
        sd0 = weights.make_state(state_names(sizes), seed, "training", dev)
        cfg = ModelConfig(num_classes=sizes.num_classes, phi=sizes.phi,
                          input_shape=sizes.input_hw, reg_max=sizes.reg_max,
                          compute_dtype=cfg_json["compute_dtype"])
        model = DCFAYolo(cfg, fold_shuffle=True)
        model.load_state_dict(apply_shuffle_spec(sd0, shuffle_fold_spec(sd0)), strict=True)
        batch = int(tr["batch"])
        tc = TrainConfig(batch_size=batch, mosaic_prob=tr["mosaic_prob"],
                         mixup_prob=tr["mixup_prob"],
                         special_aug_ratio=tr["special_aug_ratio"],
                         unfreeze_epoch=int(tr["epochs_planned"]), max_boxes=MAX_BOXES)
        self.trainer = Trainer(model.to(dev), tc, device=dev, group=group,
                               step_mode=tr["step_mode"])
        bf16 = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        self.loader = DeviceAugLoader(
            lines, sizes.input_hw, batch, train=True, max_boxes=MAX_BOXES,
            stage_hw=sizes.input_hw, mosaic=True, mosaic_prob=tr["mosaic_prob"],
            mixup=True, mixup_prob=tr["mixup_prob"],
            special_aug_ratio=tr["special_aug_ratio"],
            epoch_length=int(tr["epochs_planned"]), shuffle=True, seed=seed,
            resample_dtype=bf16 if dev.type == "cuda" else None, out_dtype=bf16,
            device=dev, rank=rank, world=world)
        self.lr = epoch0_lr(batch)
        self.epoch = 0
        self.loader.set_epoch(0)
        self.it = iter(self.loader)


def digest(snap) -> str:
    """A hash of a state snapshot's bits, entry by entry in name order."""
    h = hashlib.sha256()
    for k in sorted(snap):
        h.update(k.encode())
        h.update(snap[k].contiguous().numpy().tobytes())
    return h.hexdigest()


def nccl_durations(trace) -> list:
    """The µs of each NCCL kernel of a traced window, in launch order."""
    return [dur for name, ts, dur, _ in sorted(trace.device_ops, key=lambda op: op[1])
            if "nccl" in name.lower()]


def _batch_record(rk: Ranks, b):
    """The global batch on rank 0: ((rgb, nir), (boxes, labels, mask))."""
    images = tuple(rk.gather(t) for t in (b.rgb, b.nir))
    targets = tuple(rk.gather(t) for t in (b.gt_boxes, b.gt_labels, b.gt_mask))
    return images, targets


def rank_run(rk: Ranks, job, say=lambda msg: None, t0=None):
    """One run on every rank: set-up, the window, the trace; the program
    freed at the end.  Rank 0 (whose process started at `t0`) returns what
    the judge and the result need; the others None."""
    cell_cfg, tr, seed = job["config"], job["traffic"], job["seed"]
    dev, lead = rk.dev, rk.rank == 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    work = None
    if lead:
        work = tempfile.mkdtemp(prefix="bench_train_dp")
        lines = synth.write_dataset(work, int(tr["dataset_pairs"]), tuple(tr["image_hw"]),
                                    seed, tr["boxes_per_image"])
        box = [lines]
    else:
        box = [None]
    dist.broadcast_object_list(box, 0, group=rk.gloo)
    lines = box[0]
    t_data = time.perf_counter() - t
    t = time.perf_counter()
    port = DPPortRun(cell_cfg, tr, lines, seed, dev, rk.group, rk.rank, rk.world)
    t_build = time.perf_counter() - t
    t = time.perf_counter()
    batch, n_setup = int(tr["batch"]), int(tr["reference_steps"])
    setup = {"losses": [], "images": [], "targets": []}
    start = port.snapshot()[0] if lead else None
    for s in range(n_setup):
        b = port.next_batch()
        images, targets = _batch_record(rk, b)
        lb = port.step(b)
        if lead:
            setup["images"].append(images)
            setup["targets"].append(targets)
            setup["losses"].append(float(lb.total))
            if s == 0:
                setup["grad"] = host_copy(port.trainer.state.opt_state["trace"])
    if lead:
        end = port.snapshot()[0]
        setup["change"] = {k: end[k] - start[k] for k in start if not k.startswith("trace.")}
    sync(dev)
    say(f"[train_dp] set-up: dataset files {t_data:.3f} s, model, trainer and staged "
        f"loader {t_build:.3f} s, first {n_setup} steps {time.perf_counter() - t:.3f} s")

    # ---- the measured window; one step in it is kept for the reference ----
    judged = judged_step(tr, seed)
    t_start = time.perf_counter()
    setup_s = t_start - t0 if lead else None
    steps, marks = 0, [t_start]
    out = {}
    while not rk.flag(lead and not (steps <= judged
                                    or time.perf_counter() - t_start < job["seconds"])):
        b = port.next_batch()
        if steps == judged:
            images, targets = _batch_record(rk, b)
            before, updates = port.snapshot()
            loss = float(port.step(b).total)
            after, _ = port.snapshot()
            sums = rk.gather_object(digest(after))
            if lead:
                out.update(images=images, targets=targets, before=before, after=after,
                           updates=updates, loss=loss,
                           replica_gap=sum(d != sums[0] for d in sums))
        else:
            port.step(b)
        steps += 1
        marks.append(time.perf_counter())
    sync(dev)
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    peaks = rk.gather_object(peak)
    cards = rk.gather_object(card_of(dev))
    cpu = rk.gather_object((time.process_time(), os.sched_getaffinity(0)))
    if lead:
        say(f"[train_dp] {steps} steps of {batch} on {rk.world} ranks in {window_s:.3f} s "
            f"({steps * batch / window_s:.3f} images/s), epoch {port.epoch}, step mode "
            f"{port.trainer.step_mode}, train stem {port.trainer.train_stem}, peaks by rank "
            f"{peaks} bytes; host time a step: {step_times(marks)}; process CPU s and "
            f"cores by rank {[(round(c, 1), sorted(a)) for c, a in cpu]}")

    trace = nccl_us = None
    if job["trace"]:
        from torch.profiler import record_function

        from dcfa_yolo_tpu_torch.utils import profiling

        clear = getattr(profiling, "clear_counters", None)
        if clear is not None:
            clear()

        def one(_):
            with record_function("augment"):
                b = port.next_batch()
            with record_function("train_step"):
                port.step(b)

        # every rank traces, for its collectives' kernel times
        mine = tracing.record(one, int(tr["trace_steps"]), "step", dev)
        nccl_us = rk.gather_object(nccl_durations(mine))
        if lead:
            trace = mine
            counts = getattr(profiling, "counters", dict)()
            n = max(trace.count("train_step"), 1)
            say(f"[train_dp] traced: collectives a step "
                f"{counts.get('trainer.collectives', 0) / n:g}, bytes all-reduced a step "
                f"{counts.get('trainer.collective_bytes', 0) / n:g}, NCCL kernels by rank "
                f"{[len(d) for d in nccl_us]}")
    del port
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier(group=rk.gloo)
    if not lead:
        return None
    out.update(work=work, lines=lines, setup=setup, judged=judged, steps=steps,
               window_s=window_s, peak=max(peaks), cards=cards, setup_s=setup_s,
               trace=trace, nccl_us=nccl_us)
    return out


def run(ctx) -> Outcome:
    cell, tr, dev = ctx.cell, ctx.cell.traffic, ctx.device
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    n_ranks = int(tr["ranks"])
    w = ranks.world(os.path.abspath(__file__), n_ranks, dev)
    rk = w.rk
    job = {"config": cell.config, "traffic": tr, "seed": ctx.seed, "seconds": ctx.seconds,
           "trace": ctx.trace}
    w.clean = False
    rk.job(job)
    saved = ranks.pin(0, n_ranks) if dev.type == "cuda" else None
    try:
        got = rank_run(rk, job, ctx.say, ctx.t0)
    finally:
        if saved is not None:
            ranks.unpin(saved)  # the reference and the judge take the whole host
    w.clean = True
    sizes = sizes_of(cell.config)
    try:
        t_ref = time.perf_counter()
        fold = fold_spec(dict(state_names(sizes)))
        setup = got["setup"]
        setup["grad"] = unfold(setup["grad"], fold)
        setup["change"] = unfold(setup["change"], fold)
        before = unfold(got["before"], fold, PREFIXES)
        window = step_record(before, unfold(got["after"], fold, PREFIXES), got["loss"],
                             got["images"], got["targets"])
        n_setup = int(tr["reference_steps"])
        ref = Reference(sizes, tr, got["lines"], ctx.seed, dev)
        ref_setup, _ = ref.steps("float32", n_setup)
        ref_window = ref.window_step("float32", *split(before), got["updates"],
                                     n_setup + got["judged"])
        ctx.say(f"[train_dp] reference: {n_setup} set-up steps and window step "
                f"{got['judged']} at b{tr['batch']} in {time.perf_counter() - t_ref:.3f} s; "
                f"losses port {setup['losses'] + window['losses']} reference "
                f"{ref_setup['losses'] + ref_window['losses']}")
    finally:
        shutil.rmtree(got["work"], ignore_errors=True)
    judged = judge_train.judge({"setup": setup, "window": window},
                               {"setup": ref_setup, "window": ref_window})
    ctx.say("[train_dp] reported, not compared: " + ", ".join(
        f"{k} {v!r}" + (f" ({leaf})" if leaf else "") for k, (v, leaf) in judged.items()
        if k not in judge_train.COMPARED))
    lim = cell.limits
    checks = {k: (float(judged[k][0]), float(lim[k])) for k in judge_train.COMPARED}
    checks["replica_gap"] = (float(got["replica_gap"]), float(lim["replica_gap"]))
    batch = int(tr["batch"])
    e2e = {"train_images_per_s": got["steps"] * batch / got["window_s"],
           "peak_mem_gib": got["peak"] / 2**30, "setup_s": got["setup_s"]}
    layer = {"rate_items_per_s": e2e["train_images_per_s"], "batch": batch,
             "input_hw": sizes.input_hw, "world": n_ranks, "nccl_us": got["nccl_us"],
             "flops_per_item": yardstick.forward_flops(sizes, batch, train=True) / batch}
    return Outcome(e2e, got["steps"], 0, checks, got["peak"], got["cards"], layer,
                   got["trace"])


if __name__ == "__main__":
    raise SystemExit(ranks.serve(sys.argv[1:], rank_run))
