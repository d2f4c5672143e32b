"""Training entry point of the port, the counterpart of the root `train.py`
(reference `train_mul.py`):

    python -m dcfa_yolo_tpu_torch.train --classes-path model_data/voc_classes.txt \\
        --train-annotation 2007_train.txt --val-annotation 2007_val.txt

The same flags and defaults as `train.py`, plus `--device` (the card unless
`--device cpu`).  `--train-stem` takes the JAX names: `pallas` is kernel C,
`xla` the plain graph, and `auto` (the default) kernel C wherever it
applies.  The epoch loop is `train.py`'s: freeze-phase batch size, LR
schedule per epoch, one host read of the loss per 50 steps, the step timing
and loader capacity, validation loss on the EMA weights, `LossHistory`,
`EvalCallback` (COCO AP50 on the val lines), and periodic, best and last
checkpoints.  `--fold-shuffle` (on by default) trains the graph with the
backbones' channel shuffles folded into their consumers; checkpoints are
saved unfolded and re-folded on `--resume`, which restores parameters, BN
statistics, optimizer state, EMA and epoch.  `--compute-dtype float32` turns
TF32 off for the process (cuDNN and matmuls); `bfloat16` turns it on.
Step times are CUDA events around each step, read once an epoch.

`--distributed` trains data-parallel, one process a rank, launched by
torchrun (the environment gives each its rank and the rendezvous, as the
reference's DDP init reads it, `train_mul.py:115-127`):

    torchrun --nproc-per-node N -m dcfa_yolo_tpu_torch.train --distributed ...

NCCL and `cuda:LOCAL_RANK` on the card (a rank a card), gloo on the CPU.
`--batch-size` is the global batch and must divide by the world; each rank
loads its slice.  The step mode is the JAX Trainer's `auto` (`fused`, SyncBN
and the global loss, on the card; `split`, local BN and averaged gradients,
on the CPU with more than one rank).  Rank 0 alone prints, writes the logs
and checkpoints and runs the mAP callback; the others wait for it.

Flags of work not ported yet (`--device-aug*`, `--remat`, `--pretrained`,
`--model-dir`) are accepted and raise when set.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

_LEFT_OUT = {  # flag dest → (its default, the ROADMAP.md item that ports it)
    "pretrained": (False, "queue 1, item 8 (it waits for the pretrained "
                          "backbone weights file in the repository)"),
    "model_dir": ("model_data", "queue 1, item 8 (with --pretrained)"),
    "device_aug": (False, "queue 1, item 9"),
    "device_aug_stage": (None, "queue 1, item 9"),
    "device_aug_hbm_gb": (8.0, "queue 1, item 9"),
    "device_aug_dtype": ("bfloat16", "queue 1, item 9"),
    "remat": (False, "queue 1, item 8"),
}
_STEMS = {"auto": "auto", "pallas": "kernel", "xla": "plain"}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train DCFA-YOLO (PyTorch port)")
    p.add_argument("--classes-path", default="model_data/voc_classes.txt")
    p.add_argument("--train-annotation", default="2007_train.txt")
    p.add_argument("--val-annotation", default="2007_val.txt")
    p.add_argument("--model-path", default="",
                   help="weights to start from, loaded over the init: a port or "
                        "JAX .ckpt (EMA weights first) or the reference's .pth / .npz "
                        "(a single-modal backbone.* file fills both backbones)")
    p.add_argument("--pretrained", action="store_true", help="not ported yet")
    p.add_argument("--model-dir", default="model_data", help="not ported yet")
    p.add_argument("--resume", default="",
                   help="a checkpoint of the port to resume from (parameters, BN "
                        "statistics, EMA, optimizer state and epoch)")
    p.add_argument("--init-type", default="normal",
                   choices=["normal", "xavier", "kaiming", "orthogonal"])
    p.add_argument("--input-shape", type=int, nargs=2, default=[640, 640])
    p.add_argument("--phi", default="n", choices=list("nsmlx"))
    p.add_argument("--init-epoch", type=int, default=0)
    p.add_argument("--freeze-epoch", type=int, default=0)
    p.add_argument("--unfreeze-epoch", type=int, default=200)
    p.add_argument("--freeze-train", action="store_true")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--val-batch-size", type=int, default=0,
                   help="validation batch (0 = same as --batch-size)")
    p.add_argument("--freeze-batch-size", type=int, default=0,
                   help="batch size of the frozen-backbone phase (0 = --batch-size)")
    p.add_argument("--frozen-bifpn", action="store_true",
                   help="leave the BiFPN fusion weights untrained, as the reference")
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    p.add_argument("--init-lr", type=float, default=1e-2)
    p.add_argument("--min-lr-ratio", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.937)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--lr-decay-type", default="cos", choices=["cos", "step"])
    p.add_argument("--no-mosaic", action="store_true")
    p.add_argument("--no-mixup", action="store_true")
    p.add_argument("--mosaic-prob", type=float, default=0.5)
    p.add_argument("--mixup-prob", type=float, default=0.5)
    p.add_argument("--special-aug-ratio", type=float, default=0.7)
    p.add_argument("--max-boxes", type=int, default=64)
    p.add_argument("--save-period", type=int, default=20)
    p.add_argument("--eval-period", type=int, default=20)
    p.add_argument("--eval-map-batch-size", type=int, default=1)
    p.add_argument("--no-eval", action="store_true")
    p.add_argument("--save-dir", default="logs")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--device-aug", action="store_true", help="not ported yet")
    p.add_argument("--device-aug-stage", type=int, nargs=2, default=None,
                   metavar=("H", "W"), help="not ported yet")
    p.add_argument("--device-aug-hbm-gb", type=float, default=8.0, help="not ported yet")
    p.add_argument("--device-aug-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"], help="not ported yet")
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--fold-shuffle", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="train with the backbones' channel shuffles folded into "
                        "their consumers' weights (checkpoints stay unfolded)")
    p.add_argument("--remat", action="store_true", help="not ported yet")
    p.add_argument("--train-stem", default="auto", choices=list(_STEMS),
                   help="train stem: 'pallas' = kernel C, 'xla' = the plain "
                        "graph, 'auto' = kernel C wherever it applies")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of the first epoch here")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel over a process group from the environment "
                        "(torchrun): NCCL and cuda:LOCAL_RANK on the card, gloo on "
                        "the CPU; --batch-size is the global batch")
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    return p.parse_args(argv)


def run(argv: Optional[Sequence[str]] = None) -> Dict:
    """Train as `train.py` does; returns what the run did: its log
    directory, first epoch, EMA counter at the start, the trainer, and per
    epoch the losses, mAP, step timing and loader capacity."""
    args = parse_args(argv)
    for dest, (default, item) in _LEFT_OUT.items():
        if getattr(args, dest) != default:
            raise NotImplementedError(
                f"--{dest.replace('_', '-')} is not ported yet (ROADMAP.md, {item})")

    from dcfa_yolo_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    group, rank, world = None, 0, 1
    if args.distributed:
        import torch.distributed as dist

        from dcfa_yolo_tpu_torch.parallel.mesh import init_process_group, rank_device

        missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
        if missing:
            raise RuntimeError(f"--distributed needs {', '.join(missing)} in the "
                               "environment: launch it with torchrun")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        for flag in ("batch_size", "freeze_batch_size", "val_batch_size"):
            if getattr(args, flag) % world:
                raise ValueError(f"--{flag.replace('_', '-')} {getattr(args, flag)} "
                                 f"does not divide over {world} ranks (it is the "
                                 "global batch)")
        device = rank_device(device)
        group = init_process_group(device=device)
    try:
        return _train(args, device, group, rank, world)
    finally:
        if group is not None:
            dist.destroy_process_group()


def _train(args, device, group, rank: int, world: int) -> Dict:
    from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
    from dcfa_yolo_tpu_torch.data.loader import BatchLoader, PairedDetectionDataset
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor, get_classes
    from dcfa_yolo_tpu_torch.models.reparam import (apply_shuffle_spec, fold_opt_state,
                                                    shuffle_fold_spec)
    from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo
    from dcfa_yolo_tpu_torch.train.init_weights import reference_weights_init
    from dcfa_yolo_tpu_torch.train.schedule import get_lr_scheduler
    from dcfa_yolo_tpu_torch.train.trainer import Trainer, TrainState
    from dcfa_yolo_tpu_torch.utils.callbacks import EvalCallback, LossHistory
    from dcfa_yolo_tpu_torch.utils.checkpoint import (load_checkpoint, load_variables,
                                                      save_checkpoint)
    from dcfa_yolo_tpu_torch.utils.profiling import StepTimer, trace

    lead = rank == 0
    say = print if lead else (lambda *a, **k: None)

    def wait():
        """The other ranks wait here while rank 0 writes or evaluates."""
        if group is not None:
            torch.distributed.barrier(group)

    # --compute-dtype float32 is IEEE float32 on the card: TF32 off for cuDNN
    # convolutions and matmuls (PyTorch lets cuDNN use TF32 by default), as
    # kernel C float32 and the CPU compute it; bfloat16 lets the float32 ops
    # around its bf16 graph use TF32
    tf32 = args.compute_dtype == "bfloat16"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    class_names, num_classes = get_classes(args.classes_path)
    cfg = ModelConfig(num_classes=num_classes, phi=args.phi,
                      input_shape=tuple(args.input_shape),
                      compute_dtype=args.compute_dtype,
                      train_stem_backend=_STEMS[args.train_stem])
    tc = TrainConfig(
        seed=args.seed, init_epoch=args.init_epoch, freeze_epoch=args.freeze_epoch,
        unfreeze_epoch=args.unfreeze_epoch, freeze_train=args.freeze_train,
        batch_size=args.batch_size, optimizer_type=args.optimizer,
        init_lr=args.init_lr, min_lr_ratio=args.min_lr_ratio,
        momentum=args.momentum, weight_decay=args.weight_decay,
        lr_decay_type=args.lr_decay_type, max_boxes=args.max_boxes,
        mosaic=not args.no_mosaic, mosaic_prob=args.mosaic_prob,
        mixup=not args.no_mixup, mixup_prob=args.mixup_prob,
        special_aug_ratio=args.special_aug_ratio, save_period=args.save_period,
        eval_period=args.eval_period, save_dir=args.save_dir)

    # the canonical train graph's weights, on the host
    model = DCFAYolo(cfg)
    resume = None
    if args.resume:
        say(f"Resume from {args.resume}.")
        resume = load_checkpoint(args.resume)
        model.load_state_dict({**resume["params"], **resume["batch_stats"]}, strict=True)
    else:
        reference_weights_init(model, seed=tc.seed, init_type=args.init_type)
    if args.model_path and not args.resume:
        # over the init (`train.py:195-197`): a reference .pth / .npz imports
        # non-strictly (a single-modal `backbone.*` file fills both backbones,
        # the rest stays at init); a port or JAX checkpoint must be complete
        say(f"Load weights {args.model_path}.")
        model.load_state_dict(load_variables(args.model_path, model.state_dict),
                              strict=True)

    spec = None
    if args.fold_shuffle:
        # train in the folded space (`train.py:223-231`)
        spec = shuffle_fold_spec(model.state_dict())
        folded = DCFAYolo(cfg, fold_shuffle=True)
        folded.load_state_dict(apply_shuffle_spec(model.state_dict(), spec), strict=True)
        model = folded

    with open(args.train_annotation, encoding="utf-8") as f:
        train_lines = f.readlines()
    with open(args.val_annotation, encoding="utf-8") as f:
        val_lines = f.readlines()
    num_train, num_val = len(train_lines), len(val_lines)
    freeze_bs = args.freeze_batch_size or args.batch_size

    def phase_batch_size(epoch: int) -> int:
        return (freeze_bs if (tc.freeze_train and epoch < tc.freeze_epoch)
                else args.batch_size)

    if num_train // args.batch_size == 0:
        raise ValueError("dataset too small for this batch size")

    train_ds = PairedDetectionDataset(
        train_lines, cfg.input_shape, train=True, mosaic=tc.mosaic,
        mosaic_prob=tc.mosaic_prob, mixup=tc.mixup, mixup_prob=tc.mixup_prob,
        special_aug_ratio=tc.special_aug_ratio, epoch_length=tc.unfreeze_epoch)
    val_ds = PairedDetectionDataset(val_lines, cfg.input_shape, train=False,
                                    mosaic=False, mixup=False)

    def make_loaders(bs: int):
        return (
            BatchLoader(train_ds, bs, tc.max_boxes, shuffle=True,
                        num_workers=args.num_workers, seed=tc.seed, rank=rank,
                        world=world),
            # drop_last=False: a val set smaller than the batch still gives
            # one (padded) batch, so the val loss is never a silent 0.0
            BatchLoader(val_ds, args.val_batch_size or bs, tc.max_boxes,
                        shuffle=False, drop_last=False,
                        num_workers=args.num_workers, seed=tc.seed, rank=rank,
                        world=world),
        )

    current_bs = phase_batch_size(tc.init_epoch)
    train_loader, val_loader = make_loaders(current_bs)
    epoch_step = num_train // current_bs
    epoch_step_val = max(num_val // (args.val_batch_size or current_bs), 1)

    time_str = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    log_dir = os.path.join(tc.save_dir, "loss_" + time_str)
    loss_history = LossHistory(log_dir) if lead else None

    def predictor_factory(state_dict, conf, nms_iou, max_boxes):
        # the EMA weights of the graph being trained (folded under
        # --fold-shuffle), served by the same graph
        return YOLOPredictor(class_names, input_shape=cfg.input_shape, phi=args.phi,
                             confidence=conf, nms_iou=nms_iou, max_det=max_boxes,
                             compute_dtype=args.compute_dtype, state_dict=state_dict,
                             fold_shuffle=args.fold_shuffle, device=device)

    eval_cb = EvalCallback(predictor_factory, class_names, val_lines, log_dir,
                           map_out_path=os.path.join(log_dir, ".temp_map_out"),
                           eval_flag=not args.no_eval, period=tc.eval_period,
                           batch_size=args.eval_map_batch_size) if lead else None

    init_epoch = tc.init_epoch
    if resume is not None:
        init_epoch = int(resume["epoch"])
        ema_updates = int(resume["ema_updates"])
    else:
        ema_updates = epoch_step * init_epoch

    trainer = Trainer(model, tc, device=device, ema_updates=ema_updates,
                      train_bifpn=not args.frozen_bifpn, group=group)
    if resume is not None:
        params, ema, opt = resume["params"], resume["ema"], resume["opt_state"]
        if spec is not None:
            # checkpoints are canonical (unfolded): re-enter the folded space
            params = apply_shuffle_spec(params, spec)
            ema = apply_shuffle_spec(ema, spec)
            opt = fold_opt_state(opt, spec)
        trainer.state = TrainState(params, resume["batch_stats"], opt, ema, ema_updates)
    say(f"train stem: {trainer.train_stem} ({args.compute_dtype}, {device})"
        + (f"; {world} ranks, {trainer.step_mode} step" if group is not None else ""))

    init_lr_fit, min_lr_fit = tc.scaled_lrs()
    lr_fn = get_lr_scheduler(tc.lr_decay_type, init_lr_fit, min_lr_fit, tc.unfreeze_epoch)
    report: Dict = dict(log_dir=log_dir, init_epoch=init_epoch,
                        ema_updates_at_start=trainer.ema.updates, trainer=trainer,
                        epochs=[])

    best_val = float("inf")
    for epoch in range(init_epoch, tc.unfreeze_epoch):
        if phase_batch_size(epoch) != current_bs:
            current_bs = phase_batch_size(epoch)
            say(f"switching to batch size {current_bs} (unfreeze phase)")
            train_loader, val_loader = make_loaders(current_bs)
            epoch_step = num_train // current_bs
            epoch_step_val = max(num_val // (args.val_batch_size or current_bs), 1)
        # set_epoch after any loader swap, so the new loader draws this
        # epoch's streams and the mosaic gate sees the true epoch
        train_ds.set_epoch(epoch)
        train_loader.set_epoch(epoch)
        lr = lr_fn(epoch)
        freeze = tc.freeze_train and epoch < tc.freeze_epoch

        timer = StepTimer(device)
        step_losses: List[torch.Tensor] = []
        fetch_wait = 0.0
        running: List[float] = []  # host reads of the loss, one per 50 steps
        epoch_t0 = time.perf_counter()
        with trace(args.profile_dir if epoch == init_epoch and lead else None, device):
            it_loader = iter(train_loader)
            for it in range(epoch_step):
                t0 = time.perf_counter()
                hb = next(it_loader, None)
                fetch_wait += time.perf_counter() - t0
                if hb is None:
                    break
                batch = trainer.put_batch(hb.rgb, hb.nir, hb.gt_boxes, hb.gt_labels,
                                          hb.gt_mask)
                timer.start()
                lb = trainer.train_step(batch, lr, freeze_backbone=freeze)
                timer.stop()
                step_losses.append(lb.total)
                if it % 50 == 0:
                    running.append(float(lb.total))
                    say(f"epoch {epoch + 1}/{tc.unfreeze_epoch} it {it}/{epoch_step} "
                          f"loss {running[-1]:.3f} (run-mean {np.mean(running):.3f}) "
                          f"lr {lr:.5f}", flush=True)
            it_loader.close()
        epoch_wall = time.perf_counter() - epoch_t0
        timing = timer.summary()
        cap = train_loader.throughput()
        if timing:
            step_rate = len(step_losses) / epoch_wall if epoch_wall else 0.0
            cap_s = f"{cap:.2f} batches/s" if cap is not None else "n/a"
            # starved when the loader cannot match the pure compute rate
            compute_rate = 1000.0 / timing["mean_ms"] if timing["mean_ms"] else 0.0
            starved = (f" (STARVED: waited {fetch_wait:.1f}s on data)"
                       if cap is not None and cap < compute_rate else "")
            say(f"step timing: mean {timing['mean_ms']:.1f} ms p50 "
                  f"{timing['p50_ms']:.1f} p95 {timing['p95_ms']:.1f} over "
                  f"{timing['steps']} steps | step rate {step_rate:.2f}/s, loader "
                  f"capacity {cap_s}" + starved, flush=True)
        if train_loader.overflow_items:
            say(f"[loader] {train_loader.overflow_items} items exceeded "
                  f"max_boxes={tc.max_boxes}; {train_loader.overflow_dropped} "
                  f"smallest-area boxes dropped", flush=True)
        train_loss = float(torch.stack(step_losses).mean()) if step_losses else 0.0

        val_losses = []
        it_val = iter(val_loader)
        for it, hb in enumerate(it_val):
            if it >= epoch_step_val:
                break
            val_losses.append(trainer.eval_step(trainer.put_batch(
                hb.rgb, hb.nir, hb.gt_boxes, hb.gt_labels, hb.gt_mask)).total)
        it_val.close()
        val_loss = float(torch.stack(val_losses).mean()) if val_losses else 0.0

        say(f"Epoch {epoch + 1}/{tc.unfreeze_epoch}  "
            f"Total Loss: {train_loss:.3f} || Val Loss: {val_loss:.3f}")
        report["epochs"].append(dict(
            epoch=epoch + 1, loss=train_loss, val_loss=val_loss, map=None,
            steps=len(step_losses), timing=timing, loader_capacity=cap,
            fetch_wait_s=fetch_wait))
        if not lead:
            wait()
            continue
        loss_history.append_loss(epoch + 1, train_loss, val_loss)
        st = trainer.state
        report["epochs"][-1]["map"] = ap50 = eval_cb.on_epoch_end(epoch + 1, st.ema)
        host = {"params": st.params, "batch_stats": st.batch_stats, "ema": st.ema,
                "opt_state": st.opt_state}
        if spec is not None:
            # checkpoints stay canonical: a folded state has the same shapes
            # and would load silently into the standard graph
            host["params"] = apply_shuffle_spec(host["params"], spec, inverse=True)
            host["ema"] = apply_shuffle_spec(host["ema"], spec, inverse=True)
            host["opt_state"] = fold_opt_state(host["opt_state"], spec, inverse=True)
        payload = {**host, "ema_updates": int(st.ema_updates), "epoch": epoch + 1}
        if (epoch + 1) % tc.save_period == 0 or epoch + 1 == tc.unfreeze_epoch:
            save_checkpoint(os.path.join(
                log_dir, f"ep{epoch + 1:03d}-loss{train_loss:.3f}-"
                f"val_loss{val_loss:.3f}.ckpt"), payload)
        if val_loss <= best_val:
            best_val = val_loss
            say("Save best model to best_epoch_weights.ckpt")
            save_checkpoint(os.path.join(log_dir, "best_epoch_weights.ckpt"), payload)
        save_checkpoint(os.path.join(log_dir, "last_epoch_weights.ckpt"), payload)
        wait()
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
