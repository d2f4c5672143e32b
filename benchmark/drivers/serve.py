"""Serving traffic: a closed loop of one client that sends host uint8
RGB + NIR pairs to `YOLOPredictor` and waits for host numpy detections.

Traffic parameters (`benchmark/traffic/<mix>.json`): `batch` pairs a call
(1: `detect`, more: `detect_batch`), `pool` distinct inputs drawn from the
seed and sent in turn, `image_hw`, the predictor's `conf`, `iou`,
`max_det` and `pre_nms_topk`, `sample_calls` (window calls judged against
the reference) and `trace_calls` (calls in the traced window).

The predictor serves the deploy graph with folded shuffles in bfloat16
(`--deploy --fold-shuffle`), from a weight file written at set-up the way
users load one.  The window's end-to-end numbers: `latency_p95_ms` over
every call, `pairs_per_s` over the whole window.
"""

from __future__ import annotations

import gc
import math
import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from benchlib import judge_serve, weights, yardstick
from benchlib import trace as tracing
from benchlib.harness import Context, Outcome, sync
from benchlib.spec import sizes_of
from reference.model import ReferenceYolo, Sizes, state_names
from reference.precision import ieee
from reference.serve import greedy_nms, predict



def make_pool(seed: int, n: int, batch: int, hw) -> np.ndarray:
    """(n, 2, batch, H, W, 3) uint8 pairs drawn from the seed."""
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(0, 256, size=(n, 2, batch, *hw, 3), dtype=np.uint8)


def write_weights(sd, path: str) -> None:
    """The port's checkpoint format, EMA slot filled: what `model_path`
    loads as a user's trained weights."""
    cpu = {k: v.detach().cpu() for k, v in sd.items()}
    torch.save({"params": {}, "batch_stats": {}, "ema": cpu, "opt_state": {},
                "ema_updates": 0, "epoch": 0}, path)



def run(ctx: Context) -> Outcome:
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor

    cell, tr, dev = ctx.cell, ctx.cell.traffic, ctx.device
    sizes = sizes_of(cell.config)
    batch, hw = int(tr["batch"]), tuple(tr["image_hw"])
    pool = make_pool(ctx.seed, int(tr["pool"]), batch, hw)
    work = tempfile.mkdtemp(prefix="bench_serve")
    try:
        path = os.path.join(work, "weights.pt")
        write_weights(weights.make_state(state_names(sizes), ctx.seed, "serving", dev), path)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        pred = YOLOPredictor(
            class_names=[f"class{i}" for i in range(sizes.num_classes)],
            input_shape=sizes.input_hw, phi=sizes.phi, confidence=tr["conf"],
            nms_iou=tr["iou"], max_det=int(tr["max_det"]),
            pre_nms_topk=int(tr["pre_nms_topk"]),
            compute_dtype=cell.config["compute_dtype"], model_path=path,
            deploy=True, fold_shuffle=True, device=dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def call(i: int):
        rgb, nir = pool[i % len(pool)]
        if batch == 1:
            return [pred.detect(rgb[0], nir[0])]
        return pred.detect_batch(rgb, nir)

    for i in range(int(tr.get("warmup_calls", 3))):
        call(i)
    sync(dev)
    caps0 = dict(pred.cap_stats)

    # ---- the measured window ----
    lat, outs, failed = [], [], 0
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    i = 0
    while time.perf_counter() - t_start < ctx.seconds:
        t = time.perf_counter()
        try:
            res = call(i)
        except Exception as e:  # a failed call is missing, and counted
            failed += 1
            res = None
            ctx.say(f"call {i} failed: {e!r}")
        lat.append(time.perf_counter() - t if res is not None else math.inf)
        outs.append(res)
        i += 1
    window_s = time.perf_counter() - t_start
    n_calls = i
    q = statistics.quantiles(lat, n=100, method="inclusive") if len(lat) > 1 else lat * 99
    e2e = {"latency_p95_ms": q[94] * 1e3,
           "pairs_per_s": (n_calls - failed) * batch / window_s,
           "setup_s": setup_s}
    caps = {k: (v - caps0[k] if k != "max_candidates" else v)
            for k, v in pred.cap_stats.items()}
    ctx.say(f"[serve] {cell.name}: {n_calls} calls of {batch} in {window_s:.3f} s; "
            f"median {statistics.median(lat) * 1e3:.4f} ms, p95 {e2e['latency_p95_ms']:.4f} ms;"
            f" cap_stats {caps}")

    rng = np.random.Generator(np.random.PCG64(ctx.seed + 1))
    sample = sorted(rng.choice(n_calls, size=min(int(tr["sample_calls"]), n_calls),
                               replace=False).tolist())

    trace = None
    if ctx.trace:
        items = sorted({s % len(pool) for s in sample})
        n_tr = int(tr["trace_calls"])
        trace = tracing.record(lambda j: call(items[j % len(items)]), n_tr, "detect", dev)
        trace_items = [items[j % len(items)] for j in range(n_tr)]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ctx.say(f"[serve] peak memory {peak} bytes ({peak / 2**30:.4f} GiB)")
    pred.release_graphs()
    del pred
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference, after the window ----
    t_ref = time.perf_counter()
    ref = Reference(sizes, ctx.seed, dev, "float32")
    lim = cell.limits
    readings = []
    for s in sample:
        res = outs[s]
        p = ref.predictions(pool, s % len(pool))
        for b in range(batch):
            if res is None:
                readings.append(dict(det_gap=math.inf, nms_miss=math.inf, nms_overlap=0.0))
                continue
            boxes, scores, classes = res[b]
            readings.append(judge_serve.judge_image(
                boxes, scores, classes, p.boxes[b], p.scores[b], p.classes[b],
                image_hw=hw, conf=tr["conf"], iou_thres=tr["iou"],
                topk=int(tr["pre_nms_topk"]), max_det=int(tr["max_det"]),
                tol=lim["nms_tol"]))
    worst = judge_serve.combine(readings)
    layer = {"rate_items_per_s": e2e["pairs_per_s"], "batch": batch,
             "flops_per_item": yardstick.forward_flops(sizes, 1),
             "input_hw": sizes.input_hw,
             "k": min(int(tr["pre_nms_topk"]), n_anchors(sizes.input_hw)),
             "caps": caps}
    if trace is not None:
        per_item = {}
        for it in set(trace_items):
            pp = ref.predictions(pool, it)
            per_item[it] = sum(yardstick.candidate_pairs(pp.boxes[b], pp.scores[b],
                                                         tr["conf"], layer["k"], tr["iou"])
                               for b in range(batch))
        layer["nms_pairs_per_call"] = float(np.mean([per_item[it] for it in trace_items]))
    ctx.say(f"[serve] reference over {len(sample)} sampled calls "
            f"({len(readings)} images) in {time.perf_counter() - t_ref:.3f} s")
    checks = {k: (float(worst[k]), float(lim[k])) for k in ("det_gap", "nms_miss", "nms_overlap")}
    return Outcome(e2e, n_calls, failed, checks, peak, layer, trace)


def n_anchors(hw) -> int:
    return sum((hw[0] // s) * (hw[1] // s) for s in (8, 16, 32))




class Reference:
    """The plain float32 reference (or the precision control) on `dev`,
    from the run's seeded weights made again; predictions cached by pool
    item."""

    def __init__(self, sizes: Sizes, seed: int, dev, precision: str = "float32"):
        self.dev, self.precision = dev, precision
        self.model = ReferenceYolo(sizes, precision).to(dev)
        self.model.load_state_dict(weights.make_state(state_names(sizes), seed,
                                                      "serving", dev))
        self.cache = {}

    def predictions(self, pool, item):
        if item not in self.cache:
            rgb, nir = (torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)
                        for a in pool[item])
            with ieee():
                self.cache[item] = predict(self.model, rgb, nir)
        return self.cache[item]

    def detections(self, pool, item, tr):
        """The reference's own greedy detections (the control's answer)."""
        p = self.predictions(pool, item)
        return [greedy_nms(p.boxes[b], p.scores[b], p.classes[b], tr["conf"], tr["iou"],
                           int(tr["pre_nms_topk"]), int(tr["max_det"]))
                for b in range(p.boxes.shape[0])]


