"""The data path's cost on the card: the host loader's float32 batch against
the dataset staged in device memory and augmented there
(`data/device_aug.py`); the port's counterpart of the root
`tools/bench_device_aug.py`.

    python -m dcfa_yolo_tpu_torch.tools.bench_device_aug [--annotation F]
        [--pairs 32] [--batch-size 16] [--size 640] [--iters 20] [--device cpu]

Times, each after warm-up calls, with CUDA events around `--iters` calls
and a synchronise (the host clock on the CPU):
  1. the host loader's per-step copy of one float32 batch to the card
     (`Trainer.put_batch`, what the CLI does a step without --device-aug);
  2. the augmentation program back to back, mosaic and mixup on every
     sample, with float32 and with bf16 resampling;
  3. an augment → `Trainer.train_step` chain (phi='n', bf16 compute, bf16
     resampling), what a --device-aug step costs.
The data: `--pairs` random uint8 pairs staged at `--size`² with four boxes
each (the root tool's), or the pairs of an annotation file.  Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch


def random_staged(n: int, size: int, max_boxes: int = 64, seed: int = 0):
    """n random uint8 pairs at size², four sorted boxes each (the root
    tool's synthetic set), as a StagedDataset."""
    from dcfa_yolo_tpu_torch.data.device_aug import StagedDataset

    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (n, 2, size, size, 3), np.uint8)
    boxes = np.zeros((n, max_boxes, 5), np.float32)
    boxes[:, :4, :4] = rng.uniform(0.1, 0.9, (n, 4, 4)).astype(np.float32)
    boxes[:, :4, :4].sort(-1)
    return StagedDataset(images, boxes, np.full((n,), 4, np.int32),
                         np.full((n, 2), float(size), np.float32))


def run(annotation: str = "", pairs: int = 32, batch_size: int = 16, size: int = 640,
        iters: int = 20, device="cuda") -> dict:
    from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
    from dcfa_yolo_tpu_torch.data.device_aug import DeviceAugLoader
    from dcfa_yolo_tpu_torch.device import resolve_device
    from dcfa_yolo_tpu_torch.models.yolo import init_model
    from dcfa_yolo_tpu_torch.train.trainer import Trainer
    from dcfa_yolo_tpu_torch.utils.profiling import device_ms

    dev = resolve_device(device)
    if annotation:
        with open(annotation, encoding="utf-8") as f:
            lines = [l.strip() for l in f if l.strip()]
        staged = None
    else:
        staged = random_staged(pairs, size)
        lines = ["synthetic"] * pairs
    common = dict(max_boxes=64, mosaic_prob=1.0, mixup_prob=1.0, epoch_length=100,
                  seed=0, device=dev, out_dtype=torch.bfloat16)
    f32 = DeviceAugLoader(lines, (size, size), batch_size, staged=staged, **common)
    bf16 = DeviceAugLoader(lines, (size, size), batch_size, staged=f32.host_ds,
                           dev_data=(f32.dev_images, f32.dev_boxes, f32.dev_nbox),
                           resample_dtype=torch.bfloat16, **common)
    f32.set_epoch(0)
    params = f32.sampler.sample(np.random.Generator(np.random.PCG64(0)),
                                np.resize(np.arange(len(f32.host_ds.images)), batch_size))

    cfg = ModelConfig(num_classes=1, phi="n", input_shape=(size, size),
                      compute_dtype="bfloat16")
    trainer = Trainer(init_model(cfg, 0, dev, train=True),
                      TrainConfig(batch_size=batch_size, max_boxes=64), device=dev)
    rng = np.random.default_rng(1)
    host = (rng.random((batch_size, size, size, 3), np.float32),
            rng.random((batch_size, size, size, 3), np.float32),
            np.zeros((batch_size, 64, 4), np.float32),
            np.zeros((batch_size, 64), np.float32),
            np.zeros((batch_size, 64), np.float32))
    nbytes = sum(a.nbytes for a in host)
    put_ms = device_ms(lambda: trainer.put_batch(*host), iters, dev)
    aug_ms = {name: device_ms(lambda ld=ld: ld.augment_batch(params.idx, params),
                              iters, dev)
              for name, ld in (("float32", f32), ("bfloat16", bf16))}
    chain_ms = device_ms(
        lambda: trainer.train_step(bf16.augment_batch(params.idx, params), 1e-3),
        iters, dev)
    return dict(
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        pairs=len(f32.host_ds.images), batch_size=batch_size, size=size,
        staged_mb=f32.host_ds.images.nbytes / 1e6,
        host_batch_mb=nbytes / 1e6, host_copy_ms=put_ms,
        host_copy_gb_per_s=nbytes / put_ms / 1e6,
        aug_ms=aug_ms, aug_images_per_s={k: batch_size * 1e3 / v for k, v in aug_ms.items()},
        aug_train_step_ms=chain_ms, aug_train_images_per_s=batch_size * 1e3 / chain_ms,
        train_stem=trainer.train_stem)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--annotation", default="",
                   help="an annotation file to stage (default: random pairs)")
    p.add_argument("--pairs", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--size", type=int, default=640)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless 'cpu' is asked for")
    args = p.parse_args(argv)
    print(json.dumps(run(args.annotation, args.pairs, args.batch_size, args.size,
                         args.iters, args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
