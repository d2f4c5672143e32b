"""Capacity of the training CLI's host loader, without the model: the train
`BatchLoader` over a synthetic dataset at the CLI's defaults (mosaic and
mixup on, 640², 480×360 PNG pairs from `tools/make_synth_dataset.py`).

    python -m dcfa_yolo_tpu_torch.tools.loader_bench [--pairs 32]
        [--batch-size 8] [--num-workers 4] [--epochs 3] [--size 640]

Every epoch is iterated as fast as the loader yields.  Prints, per epoch,
the wall-clock rate (batches/s) and `BatchLoader.throughput()` (what the
pool could sustain), then one JSON line.  The first epoch decodes every
image; later ones read the decoded-image cache, as the CLI's do.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional, Sequence


def run(pairs: int = 32, batch_size: int = 8, num_workers: int = 4, epochs: int = 3,
        size: int = 640) -> dict:
    from dcfa_yolo_tpu_torch.data import voc
    from dcfa_yolo_tpu_torch.data.loader import BatchLoader, PairedDetectionDataset
    from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset

    out = dict(pairs=pairs, batch_size=batch_size, num_workers=num_workers,
               size=size, cores=os.cpu_count(), epochs=[])
    with tempfile.TemporaryDirectory() as tmp:
        make_dataset(tmp, pairs)
        devkit = os.path.join(tmp, "VOCdevkit")
        voc.generate_imagesets(devkit, trainval_percent=1.0, train_percent=0.75)
        voc.generate_annotation_files(devkit, os.path.join(tmp, "model_data",
                                                           "voc_classes.txt"),
                                      out_dir=tmp, image_ext=".png")
        with open(os.path.join(tmp, "2007_train.txt")) as f:
            lines = f.readlines()
        ds = PairedDetectionDataset(lines, (size, size), train=True)
        loader = BatchLoader(ds, batch_size, 64, shuffle=True,
                             num_workers=num_workers, seed=11)
        for epoch in range(epochs):
            ds.set_epoch(epoch)
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            n = sum(1 for _ in loader)
            wall = time.perf_counter() - t0
            if not n:
                raise ValueError(f"{len(lines)} train pairs make no batch of {batch_size}")
            out["epochs"].append(dict(epoch=epoch + 1, batches=n,
                                      wall_batches_per_s=n / wall,
                                      capacity_batches_per_s=loader.throughput()))
            print(f"[loader_bench] epoch {epoch + 1}: {n} batches in {wall:.3f} s, "
                  f"{n / wall:.3f} batches/s wall, capacity "
                  f"{loader.throughput():.3f} batches/s", flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pairs", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--size", type=int, default=640)
    args = p.parse_args(argv)
    print(json.dumps(run(args.pairs, args.batch_size, args.num_workers, args.epochs,
                         args.size)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
