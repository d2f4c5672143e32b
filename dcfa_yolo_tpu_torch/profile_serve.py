"""Where the serving path's time goes on the card: `YOLOPredictor` at
phi='n', 640², bf16, conf 0.001 (the `chip_smoke.py` serving setting).

    python -m dcfa_yolo_tpu_torch.profile_serve [--iters N] [--out FILE]

For b1 and b8 it prints the wall time of one `detect_batch` call split into
its stages (host clock, a device synchronise after each stage), then a
`torch.profiler` window over whole calls: device busy share and the kernels
with the most device time.  Needs a CUDA device; it does not fall back to
the CPU.
"""

from __future__ import annotations

import argparse
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor

    pred = YOLOPredictor(["object"], input_shape=(640, 640), phi="n",
                         confidence=0.001, nms_iou=0.5,
                         compute_dtype="bfloat16", seed=0)
    lines = [f"device {torch.cuda.get_device_name(0)}"]
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

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                pred.detect_batch(rgb, nir)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side events only (kernels, copies): an aten op's own
        # self_device_time repeats the time of the kernels it launched
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in events) / 1e6  # us -> s
        n_launch = sum(e.count for e in events)
        lines.append(
            f"b{b} profiler: wall {wall / args.iters * 1e3:.3f} ms/call, device "
            f"busy {busy / args.iters * 1e3:.3f} ms/call ({busy / wall:.3f} of "
            f"wall, idle {1 - busy / wall:.3f}), {n_launch / args.iters:.0f} "
            f"kernels and copies/call")
        events.sort(key=lambda e: -e.self_device_time_total)
        for e in events[:15]:
            lines.append(f"  b{b} {e.self_device_time_total / args.iters / 1e3:8.4f} "
                         f"ms/call  x{e.count // args.iters:<4d} {e.key[:90]}")
    report = "\n".join(lines)
    print(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
