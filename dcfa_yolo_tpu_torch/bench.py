"""Bench of the port: RGB+NIR pairs/s on one card for the full serving
pipeline (letterbox, two stems, dual-backbone forward, DFL decode,
class-offset NMS, letterbox unmap), the counterpart of the root `bench.py`.
As the root bench times the compiled pipeline (`detect_batch_jit`), this
one times the captured one (`infer/pipeline.py::detect_batch_graph`, one
CUDA graph a key, inputs copied into its static buffers, outputs copied
out); the eager pipeline (`detect_batch`, op by op) is timed beside it at
both batches (`eager_value`, `eager_b1_ms_pair`).

    python -m dcfa_yolo_tpu_torch.bench

Serving setting: phi='n', bf16 compute, the deploy graph (RepGhost modules
fused) with the channel shuffles folded into the weights, `init_model`
weights from seed 0, conf 0.5, IoU 0.3, `pre_nms_topk` 512, `max_det` 300.
Inputs are seeded uint8 (B, 480, 602, 3) pairs staged on the device once;
outputs stay on the device.  The stem autotune times the plain and the
kernel stem, captured, (where `stem_candidates` allows it),
min(BENCH_ITERS, 10) calls a trial, and keeps the faster; a candidate that
fails fails the bench.  Batch 1 is timed over BENCH_ITERS calls a trial.

Environment knobs, as in the root bench: BENCH_BATCH (128), BENCH_ITERS
(30), BENCH_SIZE (640), BENCH_NMS ('kernel' or 'plain'), BENCH_STEM
('autotune', 'kernel' or 'plain'), BENCH_FOLD_SHUFFLE (1), BENCH_CAST_W (0),
BENCH_IN_DTYPE ('u8' or 'f32'), BENCH_B1 (1: also time batch 1), and
BENCH_DEVICE ('cuda'; 'cpu' runs the eager pipeline with the plain
versions of the kernels on the CPU, where no device metric is reported and
there is no captured pipeline).

FLOPs per pair come from `utils/profiling.py::forward_flops` over one
forward of the same graph with the plain stem, so they count the same work
whichever stem runs (the flop counter cannot see inside a ctypes kernel).
MFU is against the H100's dense bf16 peak; the bench refuses to print an
MFU above 1.0.  Prints one JSON line.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

# the PyTorch reference's own FPS protocol (yolo_mul.py:132-166: forward,
# decode and NMS at batch 1) on one CPU core: 0.4064 s/pair
# (tools/ref_fps_baseline.py); a CPU number, so `vs_baseline` is a
# cross-hardware ratio
REFERENCE_CPU_PAIRS_PER_SEC = 2.461


def stem_candidates(cfg, dev: torch.device) -> list:
    """The stems the autotune times: the plain graph, and the kernel where
    it fits the model (`kernel_stem_eligible`) and its wrapper runs on
    `dev`: an sm_90 card, or the CPU, where it takes its plain version."""
    from dcfa_yolo_tpu_torch.device import kernels_supported
    from dcfa_yolo_tpu_torch.infer.pipeline import kernel_stem_eligible

    kernel = kernel_stem_eligible(cfg) and (dev.type == "cpu"
                                            or kernels_supported(dev))
    return ["plain"] + (["kernel"] if kernel else [])


def run() -> dict:
    """Run the bench as the environment configures it; returns the record
    that `main` prints."""
    from dcfa_yolo_tpu_torch.config import ModelConfig
    from dcfa_yolo_tpu_torch.device import resolve_device
    from dcfa_yolo_tpu_torch.infer.pipeline import (detect_batch, detect_batch_graph,
                                                    resolve_stem)
    from dcfa_yolo_tpu_torch.models.reparam import cast_model_conv_kernels
    from dcfa_yolo_tpu_torch.models.yolo import init_model
    from dcfa_yolo_tpu_torch.utils.profiling import (H100_BF16_FLOPS, forward_flops,
                                                     timeit_chained)

    env = os.environ.get
    batch = int(env("BENCH_BATCH", "128"))
    iters = int(env("BENCH_ITERS", "30"))
    size = int(env("BENCH_SIZE", "640"))
    nms = env("BENCH_NMS", "kernel")
    stem = env("BENCH_STEM", "autotune")
    fold_shuffle = env("BENCH_FOLD_SHUFFLE", "1") == "1"
    in_dtype = torch.float32 if env("BENCH_IN_DTYPE", "u8") == "f32" else torch.uint8
    dev = resolve_device(env("BENCH_DEVICE", "cuda"))

    cfg = ModelConfig(num_classes=1, phi="n", input_shape=(size, size),
                      compute_dtype="bfloat16")
    if stem != "autotune":
        resolve_stem(stem, cfg, dev)  # an explicit request that cannot be met raises
    model = init_model(cfg, 0, dev, deploy=True, fold_shuffle=fold_shuffle)
    # FLOPs before the optional cast: the count does not depend on it
    flops_per_pair = forward_flops(model)
    if env("BENCH_CAST_W", "0") == "1":
        cast_model_conv_kernels(model, torch.bfloat16)

    rng = np.random.Generator(np.random.PCG64(0))
    rgb, nir = (torch.from_numpy(rng.integers(0, 255, (batch, 480, 602, 3))
                                 .astype(np.uint8)).to(dev, in_dtype)
                for _ in range(2))
    image_hw = torch.tensor([[480.0, 602.0]] * batch, device=dev)

    on_card = dev.type == "cuda"

    def make_fn(stem_name, hw, serve=detect_batch_graph if on_card else detect_batch):
        def fn(r, n):
            return serve(model, r, n, hw, conf_thres=0.5, iou_thres=0.3,
                         max_det=300, pre_nms_topk=512, nms=nms, stem=stem_name)
        return fn

    autotune = None
    if stem == "autotune":
        times = {c: timeit_chained(make_fn(c, image_hw), (rgb, nir),
                                   iters=min(iters, 10), trials=2, warmup=8,
                                   device=dev)
                 for c in stem_candidates(cfg, dev)}
        stem = min(times, key=times.get)
        autotune = {c: round(batch / t, 1) for c, t in times.items()}

    dt = timeit_chained(make_fn(stem, image_hw), (rgb, nir), iters=iters,
                        subtract_fixed=True, device=dev)
    pairs_per_sec = batch / dt
    tflops = flops_per_pair * pairs_per_sec / 1e12 if on_card else None
    mfu = tflops * 1e12 / H100_BF16_FLOPS if on_card else None
    if mfu is not None and mfu > 1.0:
        raise SystemExit(
            f"IMPOSSIBLE measurement: implied MFU {mfu:.2f} > 1.0 ({tflops:.1f} "
            f"TFLOP/s vs {H100_BF16_FLOPS / 1e12:.0f} peak): timing artifact, "
            f"refusing to report")

    # batch-1 latency of the same pipeline, the reference FPS protocol's
    # operating point
    b1 = env("BENCH_B1", "1") == "1" and batch != 1

    def b1_ms_pair(**kw):
        return round(timeit_chained(make_fn("auto", image_hw[:1], **kw),
                                    (rgb[:1], nir[:1]), iters=iters,
                                    subtract_fixed=True, device=dev) * 1e3, 3)

    b1_ms = b1_ms_pair() if b1 else None
    # the eager pipeline beside the captured one, same stem, same inputs
    eager_value = eager_b1 = None
    if on_card:
        eager_value = round(batch / timeit_chained(
            make_fn(stem, image_hw, serve=detect_batch), (rgb, nir), iters=iters,
            subtract_fixed=True, device=dev), 2)
        eager_b1 = b1_ms_pair(serve=detect_batch) if b1 else None

    notes = ("hbm_gbps and hbm_util are null: PyTorch has no counterpart of "
             "XLA's compiled-executable 'bytes accessed', and no byte count is "
             "made up here. gflop_per_pair: torch.utils.flop_counter over one "
             "forward of the same graph with the plain stem (convs and matmuls "
             "at 2 FLOPs per multiply-add, no elementwise ops).")
    if not on_card:
        notes += " A CPU run: tflops and mfu are null, the rate is the CPU's."
    return {
        "metric": "pairs_per_sec_per_chip_640_batch_inference",
        "value": round(pairs_per_sec, 2),
        "unit": "pairs/s",
        "vs_baseline": round(pairs_per_sec / REFERENCE_CPU_PAIRS_PER_SEC, 2),
        "baseline": "reference full pipeline b1, its own FPS protocol "
                    "(yolo_mul.py:132-166), torch CPU 1-core: 2.461 pairs/s "
                    "- cross-hardware ratio, not GPU parity",
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "gflop_per_pair": round(flops_per_pair / 1e9, 3),
        "tflops": None if tflops is None else round(tflops, 2),
        "mfu": None if mfu is None else round(mfu, 4),
        "hbm_gbps": None,
        "hbm_util": None,
        "stem_backend": stem,
        "stem_autotune": autotune,
        "b1_ms_pair": b1_ms,
        "pipeline": "cuda_graph" if on_card else "eager",
        "eager_value": eager_value,
        "eager_b1_ms_pair": eager_b1,
        "timing": "back-to-back calls in CUDA stream order, steady-state slope "
                  "(the per-burst synchronise subtracted; "
                  "utils/profiling.timeit_chained subtract_fixed); value and "
                  "b1_ms_pair time the captured pipeline, eager_value and "
                  "eager_b1_ms_pair the eager one",
        "notes": notes,
    }


def main() -> int:
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
