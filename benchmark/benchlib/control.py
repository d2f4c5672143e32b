"""The precision control: the plain reference put in the program's place,
computed one step below the configuration's bfloat16 (fp8 operands of
every convolution and matrix product, fp8 images), judged by the cell's
own comparison against the float32 reference on the same inputs.  A
sound comparison has to call it incorrect."""

from __future__ import annotations

import shutil
import tempfile
from typing import Dict

import numpy as np

from benchlib import judge_serve, judge_train, synth


def serve(cell, seed: int, dev, precision: str = "fp8") -> Dict[str, float]:
    """The control's detections on the cell's sampled pool items."""
    from drivers.serve import Reference, make_pool, sizes_of

    tr = cell.traffic
    sizes = sizes_of(cell.config)
    batch, hw = int(tr["batch"]), tuple(tr["image_hw"])
    pool = make_pool(seed, int(tr["pool"]), batch, hw)
    rng = np.random.Generator(np.random.PCG64(seed + 1))
    items = sorted(set(rng.choice(len(pool), size=min(int(tr["sample_calls"]), len(pool)),
                                  replace=False).tolist()))
    ref = Reference(sizes, seed, dev, "float32")
    low = Reference(sizes, seed, dev, precision)
    readings = []
    for it in items:
        p = ref.predictions(pool, it)
        for b, (boxes, scores, classes) in enumerate(low.detections(pool, it, tr)):
            readings.append(judge_serve.judge_image(
                boxes, scores, classes, p.boxes[b], p.scores[b], p.classes[b],
                image_hw=hw, conf=tr["conf"], iou_thres=tr["iou"],
                topk=int(tr["pre_nms_topk"]), max_det=int(tr["max_det"]),
                tol=cell.limits["nms_tol"]))
    return judge_serve.combine(readings)


def train(cell, seed: int, dev, precision: str = "fp8") -> Dict[str, float]:
    """The control's steps against the float32 reference's: the first
    steps from the seed's weights, and a window step from the float32
    reference's point after them."""
    from drivers.train import Reference, point, sizes_of

    tr = cell.traffic
    n = int(tr["reference_steps"])
    work = tempfile.mkdtemp(prefix="bench_control")
    try:
        lines = synth.write_dataset(work, int(tr["dataset_pairs"]), tuple(tr["image_hw"]),
                                    seed, tr["boxes_per_image"])
        ref = Reference(sizes_of(cell.config), tr, lines, seed, dev)
        f32, rt = ref.steps("float32", n)
        low, _ = ref.steps(precision, n)
        at = point(rt)
        w32 = ref.window_step("float32", *at, n)
        wlow = ref.window_step(precision, *at, n)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    got = judge_train.judge({"setup": low, "window": wlow}, {"setup": f32, "window": w32})
    return {k: v for k, (v, _) in got.items()}


def run(cell, seed: int, dev, precision: str = "fp8") -> Dict[str, float]:
    """The compared numbers (training: and the reported ones) of the
    reference at `precision` against the float32 reference."""
    return (serve if cell.traffic["driver"] == "serve" else train)(cell, seed, dev,
                                                                   precision)
