"""Where the serving path's time goes on the card: `YOLOPredictor` at
phi='n', 640², bf16, conf 0.001 (the `chip_smoke.py` serving setting).

    python -m dcfa_yolo_tpu_torch.profile_serve [--iters N] [--out FILE]

For b1 and b8 it prints the wall time of one eager `detect_batch` call
split into its stages (host clock, a device synchronise after each stage),
the eager call whole (no synchronise between stages) and the captured call
whole (`detect_batch_graph`: input copied in, replay, outputs to the host),
each the median of N calls; then a `torch.profiler` window over eager
calls and one over a single replay: device busy share (the union of the
device operations' intervals) and the kernels with the most device time.
Last, the device time of the work the eager model does to its weights on
every call, which the graph replays too: each conv's weight cast to the
compute dtype and each eval BatchNorm's fold (`rsqrt`, scale, shift and
their casts; kernel A's stem fold where it runs), captured alone in a
graph of its own and timed with CUDA events.
Needs a CUDA device; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch


def _stages(pred, rgb, nir):
    """One detect_batch call, stage by stage; returns {stage: seconds}."""
    from dcfa_yolo_tpu_torch.infer.decode import correct_boxes_yxyx, decode_box
    from dcfa_yolo_tpu_torch.infer.pipeline import _kernel_stem_outs
    from dcfa_yolo_tpu_torch.ops.nms import batched_nms

    model, dev = pred.model, pred.device
    marks = [("start", time.perf_counter())]

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    with torch.inference_mode():
        r = torch.as_tensor(rgb, device=dev)
        n = torch.as_tensor(nir, device=dev)
        mark("host_to_device")
        stem_outs = _kernel_stem_outs(model, r, n)
        mark("letterbox_and_stem_kernel")
        out = model(None, None, stem_outs=stem_outs)
        mark("model_forward")
        hw = tuple(model.cfg.input_shape)
        p = decode_box(out.dbox, out.cls, out.anchors, out.strides, hw)
        boxes = torch.cat([p[..., :2] - p[..., 2:4] / 2,
                           p[..., :2] + p[..., 2:4] / 2], dim=-1)
        scores, classes = p[..., 4:].amax(-1), p[..., 4:].argmax(-1)
        mark("decode")
        res = batched_nms(boxes, scores, classes, pred.confidence, pred.nms_iou,
                          pre_nms_topk=pred.pre_nms_topk, max_det=pred.max_det)
        mark("nms")
        image_hw = torch.tensor([rgb.shape[1:3]] * len(rgb), dtype=torch.float32,
                                device=dev)
        b = correct_boxes_yxyx(res.boxes, hw, image_hw)
        for t in (b, res.scores, res.classes, res.valid):
            t.cpu()
        mark("unmap_and_device_to_host")
    return {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}


def _cast_fold_ops(model, kernel_stem: bool):
    """A function doing what the eager model does to its weights on every
    call: each conv's weight (and bias) cast to the compute dtype, each eval
    BatchNorm's fold and the casts of its scale and shift; with the kernel
    stem, kernel A's fold (`fold_stem_params`) in place of the stems' conv
    and BatchNorm.  Returns (fn, casts, folds)."""
    from dcfa_yolo_tpu_torch.models.yolo import _DTYPES
    from dcfa_yolo_tpu_torch.ops.conv import Conv
    from dcfa_yolo_tpu_torch.ops.cuda_stem import fold_stem_params
    from dcfa_yolo_tpu_torch.ops.norm import BatchNorm

    dtype = _DTYPES[model.cfg.compute_dtype]
    stems = [model.backbone_rgb.stem, model.backbone_nir.stem]
    skip = {id(m) for st in stems for m in st.modules()} if kernel_stem else set()
    convs = [m for m in model.modules() if isinstance(m, Conv) and id(m) not in skip]
    bns = [m for m in model.modules() if isinstance(m, BatchNorm) and id(m) not in skip]

    def fn():
        outs = []
        for c in convs:
            outs.append(c.weight.to(dtype))
            if c.bias is not None:
                outs.append(c.bias.to(dtype))
        for bn in bns:
            outs.extend(t.to(dtype) for t in bn.folded())
        if kernel_stem:
            for st in stems:
                outs.extend(fold_stem_params(st.conv.weight, st.bn.weight, st.bn.bias,
                                             st.bn.running_mean, st.bn.running_var,
                                             eps=st.bn.eps))
        return outs
    casts = sum(1 + (c.bias is not None) for c in convs) + 2 * len(bns)
    return fn, casts, len(bns) + (2 if kernel_stem else 0)


def _graph_ms(fn, iters: int) -> float:
    """Device ms of one replay of `fn` captured alone (CUDA events around
    `iters` replays)."""
    from dcfa_yolo_tpu_torch.utils.profiling import device_ms

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return device_ms(g.replay, iters)


def _device_events(prof):
    """Device-side events (kernels, copies) of a profiler window: an aten
    op's own self_device_time repeats the time of the kernels it launched."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from dcfa_yolo_tpu_torch.infer.pipeline import (detect_batch, detect_batch_graph,
                                                    resolve_stem)
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
    from dcfa_yolo_tpu_torch.utils.profiling import device_busy

    pred = YOLOPredictor(["object"], input_shape=(640, 640), phi="n",
                         confidence=0.001, nms_iou=0.5,
                         compute_dtype="bfloat16", seed=0)
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    lines = [f"device {torch.cuda.get_device_name(0)} ({smi.stdout.strip()})"]
    nkw = dict(conf_thres=pred.confidence, iou_thres=pred.nms_iou,
               max_det=pred.max_det, pre_nms_topk=pred.pre_nms_topk)
    for b in (1, 8):
        rng = np.random.default_rng(b)
        rgb = rng.integers(0, 256, (b, 480, 640, 3), dtype=np.uint8)
        nir = rng.integers(0, 256, (b, 480, 640, 3), dtype=np.uint8)
        for _ in range(3):
            pred.detect_batch(rgb, nir)
        runs = [_stages(pred, rgb, nir) for _ in range(args.iters)]
        med = {k: float(np.median([r[k] for r in runs])) * 1e3 for k in runs[0]}
        total = sum(med.values())
        lines.append(f"b{b} stages (median of {args.iters}, ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in med.items()) + f" | sum {total:.3f}")
        hw = np.tile(np.asarray(rgb.shape[1:3], np.float32), (b, 1))

        def whole(serve):
            t0 = time.perf_counter()
            for t in serve(pred.model, rgb, nir, hw, **nkw):
                t.cpu()
            return time.perf_counter() - t0

        whole(detect_batch_graph)  # captures this key
        eager = statistics.median(whole(detect_batch) for _ in range(args.iters)) * 1e3
        captured = statistics.median(
            whole(detect_batch_graph) for _ in range(args.iters)) * 1e3
        lines.append(f"b{b} whole call (median of {args.iters}, ms, host input in, "
                     f"results on the host): eager {eager:.3f}, captured {captured:.3f} "
                     f"({eager / captured:.2f}x)")

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                pred.detect_batch(rgb, nir)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = _device_events(prof)
        busy, n_launch = device_busy(prof)
        lines.append(
            f"b{b} profiler: wall {wall / args.iters * 1e3:.3f} ms/call, device "
            f"busy {busy / args.iters * 1e3:.3f} ms/call ({busy / wall:.3f} of "
            f"wall, idle {1 - busy / wall:.3f}), {n_launch / args.iters:.0f} "
            f"kernels and copies/call")
        events.sort(key=lambda e: -e.self_device_time_total)
        for e in events[:15]:
            lines.append(f"  b{b} {e.self_device_time_total / args.iters / 1e3:8.4f} "
                         f"ms/call  x{e.count // args.iters:<4d} {e.key[:90]}")

        # one replay of the captured call under the profiler
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            detect_batch_graph(pred.model, rgb, nir, hw, **nkw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = _device_events(prof)
        busy, n_launch = device_busy(prof)
        rsqrt = [e for e in events if "rsqrt" in e.key]
        if events:
            lines.append(
                f"b{b} profiler, one replay: wall {wall * 1e3:.3f} ms, device busy "
                f"{busy * 1e3:.3f} ms ({busy / wall:.3f} of wall, idle "
                f"{1 - busy / wall:.3f}), {n_launch} kernels and "
                f"copies; rsqrt kernels {sum(e.count for e in rsqrt)} taking "
                f"{sum(e.self_device_time_total for e in rsqrt) / 1e3:.4f} ms")
        else:
            lines.append(f"b{b} profiler, one replay: no device events traced; "
                         f"busy share not measured")

    kernel_stem = resolve_stem(pred.stem, pred.model.cfg, pred.device) == "kernel"
    fn, casts, folds = _cast_fold_ops(pred.model, kernel_stem)
    lines.append(f"weight casts and BN folds of one call, captured alone: {casts} casts, "
                 f"{folds} folds, {_graph_ms(fn, 50):.4f} ms device time (CUDA events, "
                 f"mean of 50 replays)")
    report = "\n".join(lines)
    print(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
