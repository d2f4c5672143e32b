"""Where the train step's time goes on the card: `Trainer.train_step` at
phi='n', 640², bf16, b16 SGD-nesterov from the reference init (the
`chip_smoke.py` training setting).

    python -m dcfa_yolo_tpu_torch.profile_train [--iters N] [--out FILE]

It prints the wall time of one step split into forward, loss, backward and
optimizer + EMA (host clock, a device synchronise after each stage; the
median of N steps), then a `torch.profiler` window over whole steps: device
busy share (the union of the device operations' intervals) and the kernels
with the most device time.  Needs a CUDA device; it does not fall back to
the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def synthetic_batch(b, hw, max_boxes, seed):
    """One seeded batch as host arrays for `Trainer.put_batch`: uint8 pairs
    scaled to [0, 1] (float32 NHWC) and 1-8 class-0 boxes per image, each
    inside the image, padded to `max_boxes`."""
    from dcfa_yolo_tpu_torch.train.loss import pad_targets

    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8) / np.float32(255)
            for _ in range(2)]
    rows = []
    for j in range(b):
        for _ in range(int(rng.integers(1, 9))):
            wh = rng.uniform(0.05, 0.4, 2)
            rows.append([j, 0, *rng.uniform(wh / 2, 1 - wh / 2), *wh])
    gt = pad_targets(np.asarray(rows, np.float32), b, max_boxes, hw)
    return tuple(i.astype(np.float32) for i in imgs) + gt


def step_stages(trainer, batch, lr):
    """One train step split into its stages, a device synchronise after
    each: {stage: ms} on the host clock."""
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    feats = trainer.forward(batch)
    mark()
    lb = trainer.loss(feats, batch)
    mark()
    grads = trainer.backward(lb.total)
    mark()
    trainer.update(grads, lr)
    mark()
    names = ("forward", "loss", "backward", "optimizer_and_ema")
    return {n: (marks[i + 1] - marks[i]) * 1e3 for i, n in enumerate(names)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
    from dcfa_yolo_tpu_torch.models.yolo import init_model
    from dcfa_yolo_tpu_torch.train.trainer import Trainer
    from dcfa_yolo_tpu_torch.utils.profiling import device_busy

    tc = TrainConfig()
    cfg = ModelConfig(num_classes=1, phi="n", input_shape=(640, 640),
                      compute_dtype="bfloat16")
    trainer = Trainer(init_model(cfg, 0, "cuda", train=True), tc)
    batch = trainer.put_batch(*synthetic_batch(tc.batch_size, cfg.input_shape,
                                               tc.max_boxes, seed=0))
    lr = tc.scaled_lrs()[0]
    for _ in range(3):
        trainer.train_step(batch, lr)
    runs = [step_stages(trainer, batch, lr) for _ in range(args.iters)]
    med = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    lines = [f"device {torch.cuda.get_device_name(0)}, cuDNN TF32 "
             f"{torch.backends.cudnn.allow_tf32}",
             f"b{tc.batch_size} stages (median of {args.iters}, ms): " + ", ".join(
                 f"{k} {v:.3f}" for k, v in med.items())
             + f" | sum {sum(med.values()):.3f}"]

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            trainer.train_step(batch, lr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): an aten op's own
    # self_device_time repeats the time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy, n_launch = device_busy(prof)
    lines.append(
        f"profiler: wall {wall / args.iters * 1e3:.3f} ms/step, device busy "
        f"{busy / args.iters * 1e3:.3f} ms/step ({busy / wall:.3f} of wall, idle "
        f"{1 - busy / wall:.3f}), {n_launch / args.iters:.0f} kernels and copies/step")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:25]:
        lines.append(f"  {e.self_device_time_total / args.iters / 1e3:8.4f} ms/step  "
                     f"x{e.count // args.iters:<5d} {e.key[:100]}")
    report = "\n".join(lines)
    print(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
