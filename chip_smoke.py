#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dcfa_yolo_tpu_torch`) on one NVIDIA
Hopper GPU: builds the hand-written kernels from `dcfa_yolo_tpu_torch/csrc/`,
holds each against its plain PyTorch version at its path's shapes, times it,
then drives the paths of the port at phi='n' 640²: serving through
`YOLOPredictor` in bf16 (kernels A and B), training through
`Trainer.train_step` in bf16 (kernel C), backbone
rematerialization (`--remat`: kernel C in the forward and in the
backward's recompute), the training CLI (`python -m
dcfa_yolo_tpu_torch.train`, in-process) in float32 (kernel C's float32
instantiation, and kernel B in its mAP epoch; then `--device-aug --remat`,
then `--pretrained` from a synthesized backbone file),
augmentation on the card from the staged dataset (`data/device_aug.py`,
float32 against the CPU, bf16 against float32), the stem split probe
(kernel A and its four variants, all on A's core), the deploy serving
graph, the captured serving pipeline (`detect_batch_graph`, kernels A and
B inside one CUDA graph a key, held bit-equal to the eager pipeline), the
trained-weights fixture served end to end, the serving CLIs
(`python -m dcfa_yolo_tpu_torch.predict` / `.get_map`, in-process), weights
in and out (the reference's `.pth` against its own outputs and served
through the graph, the export to its `.npz` and back, the `torch.export`
artifact of the deploy pipeline), the opt-in serving graphs (paired
backbones, split neck concats, with and without deploy, against the graphs
they stand in for), the captured pipeline at 320², 1280² and 320×416 and
at phi s-x, data-parallel training and serving (2 gloo ranks spawned on
this one card, fused and split steps against the one-process step with
kernel C's sums all-reduced, then an NCCL world of 1), and the bench; it
checks that each path went through its kernels and agrees with its
all-plain (or train-graph, or eager, or one-process) version.

    python3 chip_smoke.py

Prints one line per phase, then a JSON line with every kernel's numbers,
then `{"ok": true, "device": {...}}` as the last line.  Any failed check
exits non-zero before that line; so does a machine without CUDA.  TF32 is
off throughout: the float32 plain versions are compared in full float32.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
CARD = "?"  # nvidia-smi's name and power limit, set by phase_device
# the shapes (B, H, W) where kernels A and C's persistent tile walk can go
# wrong: b1 and b3, 320² and 1280², tiles that do not divide the image
EDGE_SHAPES = [(1, 640, 640), (3, 640, 640), (1, 320, 320), (3, 320, 320),
               (1, 1280, 1280), (2, 64, 130), (3, 30, 18), (1, 66, 66)]


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def phase_device():
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    CARD = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(CARD)
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | capability {cap} | "
          f"devices {torch.cuda.device_count()}")
    check(cap == (9, 0), f"needs compute capability (9, 0), got {cap}")


def phase_build():
    from dcfa_yolo_tpu_torch.ops import _build

    _build.load_library()
    print(f"[build] nvcc sm_90a, {len(_build.SOURCES)} sources in parallel: "
          f"{_build.BUILD_SECONDS:.1f} s")
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / (name.rsplit(".", 1)[0] + ".log"))
        fn, stack = "?", ""
        for line in (log.read_text().splitlines() if log.exists() else []):
            m = re.search(r"Compiling entry function .*?\d([a-z][a-z_]*_kernel)"
                          r"(ILi(\d)E|I13__nv_bfloat16E|IfE)?", line)
            if m:
                arg = {"I13__nv_bfloat16E": "bf16", "IfE": "f32"}.get(
                    m.group(2), m.group(3))
                fn = m.group(1) + (f"<{arg}>" if arg else "")
            elif "stack frame" in line:
                stack = line.strip()
            elif "Used" in line:
                print(f"[build] {name} {fn}: {line.split(':', 1)[1].strip()}; {stack}")
    # the kernels on the stem core (A, C, the probe's four variants) as the
    # card reports them (the persistent grid's size comes from
    # resident_ctas): at most 128 registers, no stack and at least two CTAs
    # resident on every SM
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in _build.STEM_KERNELS:
        info = _build.stem_kernel_info(name, torch.device("cuda"))
        print(f"[build] {name}: {info['registers']} registers, {info['stack_bytes']} B "
              f"stack, {info['static_smem']} B static + {info['dynamic_smem']} B dynamic "
              f"shared memory, {info['resident_ctas']} CTAs resident "
              f"({info['resident_ctas'] / sms:g} an SM)")
        check(info["registers"] <= 128 and info["stack_bytes"] == 0
              and info["resident_ctas"] >= 2 * sms,
              f"{name} needs {info['registers']} registers and {info['stack_bytes']} B "
              f"of stack, {info['resident_ctas']} CTAs resident on {sms} SMs (at most "
              f"128, none, at least 2 an SM)")


def serve_inputs(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, 480, 640, 3), dtype=np.uint8),
            rng.integers(0, 256, (b, 480, 640, 3), dtype=np.uint8))


def stem_library(canvas, w, bias):
    """Kernel A's yardstick: the same function as one cuDNN bf16 conv (bias
    included), max pool and ReLU."""
    import torch.nn.functional as F

    y = F.conv2d(canvas, w, bias.to(torch.bfloat16))
    return torch.relu(F.max_pool2d(y, 3, 2, 1))


def phase_stem(model, dev):
    """Kernel A vs stem_eval_plain (v4 class) at the edge shapes of its
    persistent tile walk, then at the serving path's shapes (b8 and b1 640²,
    the letterboxed canvas of 480×640 pairs, weights of the served model),
    where it is timed beside its plain version and cuDNN."""
    from dcfa_yolo_tpu_torch.ops import cuda_stem
    from dcfa_yolo_tpu_torch.ops.resize import letterbox_batch_cf
    from dcfa_yolo_tpu_torch.utils.profiling import H100_BF16_FLOPS, bound, device_ms

    st = model.backbone_rgb.stem
    w, bias = cuda_stem.fold_stem_params(st.conv.weight, st.bn.weight, st.bn.bias,
                                         st.bn.running_mean, st.bn.running_var)
    held = lambda canvas, what: stem_eval_held(canvas, w, bias, what)

    # the shapes the persistent tile walk can get wrong: b1 and b3, 320² and
    # 1280², tiles that do not divide the image (random raw canvases)
    rng = np.random.default_rng(SEED + 2)
    for b, h, wd in EDGE_SHAPES:
        canvas = np.zeros((b, 3, h + 2, wd + 2), np.float32)
        canvas[:, :, 1:-1, 1:-1] = rng.integers(0, 256, (b, 3, h, wd))
        held(torch.from_numpy(canvas).to(dev, torch.bfloat16), f"{b}x{h}x{wd}")
    print(f"[stem] v4 class against stem_eval_plain at {len(EDGE_SHAPES)} edge shapes "
          f"{EDGE_SHAPES}: held")
    res = {}
    for b in (8, 1):
        rgb, _ = serve_inputs(b, SEED + 1)
        canvas = letterbox_batch_cf(torch.from_numpy(rgb).to(dev), (640, 640))
        canvas = canvas.to(torch.bfloat16).contiguous()
        out, err, frac = held(canvas, f"b{b}")
        nbytes = canvas.numel() * 2 + out.numel() * 2 + w.numel() * 2 + bias.numel() * 4
        flops = 2 * b * 640 * 640 * 16 * 27
        bound_ms, bound_by = bound(nbytes, flops, H100_BF16_FLOPS)
        res[b] = dict(
            max_abs_err=err.max().item(), bit_equal=frac,
            ms=device_ms(lambda: cuda_stem.stem_eval(canvas, w, bias), 50),
            plain_ms=device_ms(lambda: cuda_stem.stem_eval_plain(canvas, w, bias), 10),
            library_ms=device_ms(lambda: stem_library(canvas, w, bias), 50),
            bound_ms=bound_ms, bound_by=bound_by)
        print(f"[stem] b{b} 640²: bit-equal {frac:.6f}, max_abs_err "
              f"{res[b]['max_abs_err']:.4g} | kernel_ms {res[b]['ms']:.4f} "
              f"plain_ms {res[b]['plain_ms']:.4f} library_ms(cuDNN conv+pool+relu) "
              f"{res[b]['library_ms']:.4f} bound_ms {bound_ms:.5f} ({bound_by}) | "
              + multiples(res[b]))
    return res[8]


def stem_eval_held(canvas, w, bias, what):
    """Kernel A against stem_eval_plain on one canvas: finite, 0.999 of the
    outputs bit-equal and all within atol 0.03 + rtol 0.02 (the v4 class).
    Returns (kernel output, |error|, bit-equal share)."""
    from dcfa_yolo_tpu_torch.ops import cuda_stem

    out = cuda_stem.stem_eval(canvas, w, bias)
    torch.cuda.synchronize()
    ref = cuda_stem.stem_eval_plain(canvas, w, bias)
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    frac = (o == r).float().mean().item()
    ok = bool(torch.all(err <= 0.03 + 0.02 * r.abs())) and frac >= 0.999
    check(bool(torch.isfinite(o).all()), f"stem {what}: kernel output not finite")
    check(ok, f"stem {what}: {frac:.6f} bit-equal (need 0.999), max err "
          f"{err.max().item():.4g} (atol 0.03, rtol 0.02)")
    return out, err, frac


def multiples(t):
    """A kernel's time as a multiple of its bound and of its library call."""
    lib = ("null" if t["library_ms"] is None
           else f"{t['ms'] / t['library_ms']:.3f}x library")
    return f"{t['ms'] / t['bound_ms']:.2f}x bound, {lib}"


def nms_pairs(boxes, alive, thr):
    """IoU evaluations the greedy pass needs on this data: each kept row
    against every later candidate still alive at its turn."""
    bx = boxes.cpu().numpy()
    al = alive.cpu().numpy().copy()
    pairs = 0
    area = (bx[..., 2] - bx[..., 0]) * (bx[..., 3] - bx[..., 1])
    for b in range(bx.shape[0]):
        a = al[b]
        n = int(np.nonzero(a)[0].max()) + 1 if a.any() else 0
        for i in range(n):
            if not a[i]:
                continue
            later = np.nonzero(a[i + 1:n])[0] + i + 1
            pairs += len(later)
            iw = np.clip(np.minimum(bx[b, later, 2], bx[b, i, 2]) - np.maximum(bx[b, later, 0], bx[b, i, 0]), 0, None)
            ih = np.clip(np.minimum(bx[b, later, 3], bx[b, i, 3]) - np.maximum(bx[b, later, 1], bx[b, i, 1]), 0, None)
            inter = iw * ih
            den = area[b, later] + area[b, i] - inter + np.float32(1e-7)
            a[later[inter / den > np.float32(thr)]] = False
    return pairs


def kernel_pairs(alive):
    """IoU pairs kernel B's phase 1 evaluates on this data: each alive row
    against every column of its 64 x 64 tiles on or above the diagonal."""
    k = alive.shape[1]
    tiles = -(-k // 64)
    rows = torch.arange(k, device=alive.device)
    return int((alive * (64 * (tiles - rows // 64))).sum())


def nms_phase_us(boxes, alive, thr, calls=10):
    """Device µs a call of kernel B's two phases, mask and scan, from a
    torch.profiler trace of `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    from dcfa_yolo_tpu_torch.ops import cuda_nms

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            cuda_nms.greedy_suppress(boxes, alive, thr)
        torch.cuda.synchronize()
    us = {"mask": 0.0, "scan": 0.0}
    for e in prof.key_averages():
        for phase in us:
            if f"nms_{phase}_kernel" in e.key:
                us[phase] += e.device_time_total / calls
    return us


def time_nms(boxes, alive, thr, scores=None):
    """Kernel B against greedy_suppress_plain (keep masks exactly equal),
    its phase-1 words against suppress_mask_plain wherever the scan reads
    them, two launches bit-identical; then its time beside its bound."""
    from dcfa_yolo_tpu_torch.ops import _build, cuda_nms
    from dcfa_yolo_tpu_torch.utils.profiling import H100_FP32_FLOPS, bound, device_ms

    b, k = alive.shape
    keep, mask = cuda_nms.greedy_suppress_with_mask(boxes, alive, thr)
    keep2, mask2 = cuda_nms.greedy_suppress_with_mask(boxes, alive, thr)
    torch.cuda.synchronize()
    ref = cuda_nms.greedy_suppress_plain(boxes, alive, thr)
    check(torch.equal(keep, ref), f"NMS keep mask differs from the plain "
          f"version at B={b}, K={k}: {(keep != ref).sum().item()} entries")
    reads = cuda_nms.scan_reads(alive)
    words = cuda_nms.suppress_mask_plain(boxes, alive, thr)
    check(torch.equal(mask[reads], words[reads]),
          f"NMS phase-1 words differ from suppress_mask_plain at B={b}, K={k}: "
          f"{(mask[reads] != words[reads]).sum().item()} of {int(reads.sum())}")
    check(torch.equal(keep, keep2) and torch.equal(mask[reads], mask2[reads]),
          f"NMS: two launches differ at B={b}, K={k}")
    lib_ms = None
    if importlib.util.find_spec("torchvision") is not None and scores is not None:
        import torchvision

        # one call over every image's alive candidates, images kept apart by
        # index (classes are already apart by the coordinate offset)
        img = torch.arange(b, device=boxes.device)[:, None].expand(b, k)
        lib_ms = device_ms(lambda: torchvision.ops.batched_nms(
            boxes[alive], scores[alive], img[alive], thr), 10)
    pairs = nms_pairs(boxes, alive, thr)
    bound_ms, bound_by = bound(b * k * 18, 12 * pairs, H100_FP32_FLOPS)
    return dict(
        max_abs_err=float((keep.int() - ref.int()).abs().max()),
        kept=int(ref.sum()), pairs=pairs, kernel_pairs=kernel_pairs(alive),
        scratch_bytes=mask.untyped_storage().nbytes(),
        scan_smem=_build.load_library().nms_scan_smem(k),
        phase_us=nms_phase_us(boxes, alive, thr),
        ms=device_ms(lambda: cuda_nms.greedy_suppress(boxes, alive, thr), 20),
        plain_ms=device_ms(lambda: cuda_nms.greedy_suppress_plain(boxes, alive, thr), 2,
                           warmup=1),
        library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)


def nms_boxes(b, k, seed):
    """Seeded clustered boxes with IoUs exactly at 0.5 (every ninth pair)
    and 10% dead candidates, an all-dead image where b > 1, and sorted
    scores."""
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(40, 600, (b, 6, 2))[np.arange(b)[:, None], rng.integers(0, 6, (b, k))]
    cxy = cxy + rng.normal(0, 12, (b, k, 2))
    wh = rng.uniform(20, 90, (b, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    boxes[:, 0:k - 1:9] = [0, 0, 16, 8]   # IoU exactly 0.5 with the next
    boxes[:, 1:k:9] = [0, 0, 8, 8]
    alive = rng.random((b, k)) < 0.9
    if b > 1:
        alive[b // 2] = False               # an all-dead image
    scores = np.sort(rng.random((b, k)).astype(np.float32), axis=1)[:, ::-1].copy()
    return boxes, alive, scores


def phase_nms(dev):
    """Kernel B vs greedy_suppress_plain at B = 1 / 8 / 32 and K = 1024 (the
    serving K), then at K = 33, 2048 and 8400 (the eval's K at 640²) at
    B = 1 and 8: keep masks equal, phase-1 words equal, two launches
    bit-identical; timed beside its bound."""
    shapes = [(1, 1024), (8, 1024), (32, 1024)] + [(b, k) for k in (33, 2048, 8400)
                                                   for b in (1, 8)]
    for b, k in shapes:
        # K=1024 keeps the seeds of the first port's runs, so that its times
        # compare on the same boxes
        boxes, alive, scores = nms_boxes(b, k, SEED + b + (k if k != 1024 else 0))
        t = time_nms(torch.from_numpy(boxes).to(dev), torch.from_numpy(alive).to(dev),
                     0.5, torch.from_numpy(scores).to(dev))
        lib = "null" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        print(f"[nms] B={b} K={k}: keep masks and phase-1 words equal, two launches "
              f"identical (kept {t['kept']}; IoU pairs {t['pairs']} needed, "
              f"{t['kernel_pairs']} evaluated; scratch {t['scratch_bytes']} B, scan "
              f"shared memory {t['scan_smem']} B) | "
              f"kernel_ms {t['ms']:.4f} plain_ms {t['plain_ms']:.2f} library_ms {lib} "
              f"bound_ms {t['bound_ms']:.6f} ({t['bound_by']}) | "
              f"{t['ms'] / t['bound_ms']:.0f}x bound; device us mask "
              f"{t['phase_us']['mask']:.2f} scan {t['phase_us']['scan']:.2f}")


def phase_serve(dev):
    """The serving path: YOLOPredictor at phi='n', 640², bf16, conf 0.001 —
    three single-pair requests, then one b8 batch, through the predictor's
    CUDA graphs (captured before), with the launch counts read around
    exactly that run."""
    from dcfa_yolo_tpu_torch.infer.pipeline import predict
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
    from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem
    from dcfa_yolo_tpu_torch.ops.nms import _select_candidates, batched_nms

    kw = dict(input_shape=(640, 640), phi="n", confidence=0.001, nms_iou=0.5,
              compute_dtype="bfloat16", seed=SEED)
    pred = YOLOPredictor(["object"], **kw)
    singles = [serve_inputs(1, SEED + 10 + i) for i in range(3)]
    rgb8, nir8 = serve_inputs(8, SEED + 20)
    # the predictor serves through one CUDA graph a key: capture the b1 and
    # b8 graphs first, so that the counted run below is replays only
    pred.detect(singles[0][0][0], singles[0][1][0])
    pred.detect_batch(rgb8, nir8)

    cuda_stem.LAUNCHES = 0
    cuda_nms.LAUNCHES = 0
    answers = [pred.detect(r[0], n[0]) for r, n in singles]
    batch = pred.detect_batch(rgb8, nir8)
    torch.cuda.synchronize()
    launches = {"stem_eval": cuda_stem.LAUNCHES, "nms_suppress": cuda_nms.LAUNCHES}
    print(f"[serve] 3 single-pair requests + 1 b8 batch: launches {launches}, "
          f"detections {[len(a[0]) for a in answers]} + "
          f"{[len(d[0]) for d in batch]}, cap_stats {pred.cap_stats}")
    check(launches["stem_eval"] == 2 * 4 and launches["nms_suppress"] == 4,
          f"expected 8 stem and 4 NMS launches, got {launches}")
    for boxes, scores, classes in answers + batch:
        check(boxes.ndim == 2 and boxes.shape[1] == 4 and len(boxes) > 0,
              "no detections at conf 0.001")
        check(np.isfinite(boxes).all() and np.isfinite(scores).all(),
              "non-finite detections")
        check(((scores >= 0.001) & (scores <= 1.0)).all() and (classes == 0).all(),
              "scores or classes out of range")

    # agreement with the all-plain path (stem='plain' = the ConvMaxpool
    # graph, nms='plain').  bf16 rounds differently in the two stems, and
    # with random weights neighbouring anchors tie within ~1e-4 in score, so
    # the greedy result at conf 0.001 is chaotic under any rounding change;
    # the check holds the per-anchor predictions to the JAX criterion's
    # score tolerance (0.005) and boxes to 0.5 px at 640² (CPU rehearsal
    # measured 0.074 px), and the NMS stage to exact equality on the same
    # predictions.
    plain = YOLOPredictor(["object"], nms="plain", stem="plain", **kw)
    bk, sk, ck = predict(pred.model, rgb8, nir8, stem="kernel")
    bp, sp, cp = predict(plain.model, rgb8, nir8, stem="plain")
    box_err = ((bk - bp).abs().max() * 640).item()
    score_err = (sk - sp).abs().max().item()
    print(f"[serve] kernel vs all-plain path, b8 per-anchor: max |Δscore| "
          f"{score_err:.3g} (tol 0.005), max |Δbox| {box_err:.3g} px (tol 0.5)")
    check(torch.equal(ck, cp) and score_err <= 0.005 and box_err <= 0.5,
          "kernel path disagrees with the all-plain path")
    # pre_nms_topk 2048 and 8400: the K that get_map's auto-raise reaches at
    # 640² (8400 anchors, all above conf 0.001)
    for topk in (1024, 2048, 8400):
        nms_kw = dict(conf_thres=0.001, iou_thres=0.5, pre_nms_topk=topk, max_det=300)
        rk = batched_nms(bk, sk, ck, backend="kernel", **nms_kw)
        rp = batched_nms(bk, sk, ck, backend="plain", **nms_kw)
        for name in rk._fields:
            check(torch.equal(getattr(rk, name), getattr(rp, name)),
                  f"NMS {name} differs between kernel and plain on the served "
                  f"predictions at pre_nms_topk {topk}")
        print(f"[serve] NMS kernel == plain on the served b8 predictions at "
              f"pre_nms_topk {topk} (valid {rk.valid.sum(-1).tolist()}, "
              f"candidates {rk.n_candidates.tolist()})")
    # the final detections of the two paths, reported and not checked (see
    # above): the share of output slots that agree under the JAX criterion
    ek, ep = pred._run(rgb8, nir8, None), plain._run(rgb8, nir8, None)
    agree = ((ek.valid == ep.valid) & (ek.classes == ep.classes)
             & (np.abs(ek.boxes - ep.boxes).max(-1) <= 0.01)
             & (np.abs(ek.scores - ep.scores) <= 0.005))
    print(f"[serve] end to end, kernel vs all-plain path at conf 0.001: "
          f"{agree.mean():.4f} of {agree.size} output slots agree (boxes 0.01 px, "
          f"scores 0.005, classes and valid equal); images fully equal: "
          f"{int(agree.all(-1).sum())} of {len(agree)}")

    # kernel B at the main path's own b8 input, for the kernels line
    conf = torch.tensor(0.001, device=dev)
    _, top_s, _, alive, off = _select_candidates(bk, sk, ck.to(torch.int32), conf, 1024)
    nms_t = time_nms(off.contiguous(), alive, 0.5, top_s)
    print(f"[serve] NMS at the served b8 input: kernel_ms {nms_t['ms']:.4f} "
          f"plain_ms {nms_t['plain_ms']:.2f} bound_ms {nms_t['bound_ms']:.6f} "
          f"({nms_t['bound_by']}, {nms_t['pairs']} IoU pairs needed, "
          f"{nms_t['kernel_pairs']} evaluated; kept {nms_t['kept']}) | "
          f"{nms_t['ms'] / nms_t['bound_ms']:.0f}x bound; device us mask "
          f"{nms_t['phase_us']['mask']:.2f} scan {nms_t['phase_us']['scan']:.2f}")

    # throughput of the served path (host clock, ends in a device sync)
    def rate(fn, pairs, iters):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return pairs * iters / (time.perf_counter() - t0)

    b1 = rate(lambda: pred.detect(singles[0][0][0], singles[0][1][0]), 1, 20)
    b8 = rate(lambda: pred.detect_batch(rgb8, nir8), 8, 10)
    print(f"[serve] pairs/s (YOLOPredictor, 640² bf16, conf 0.001): b1 {b1:.1f} "
          f"({1e3 / b1:.2f} ms/pair), b8 {b8:.1f}")
    return launches, nms_t


def stem_train_sum_tol(dtype):
    """Kernel C's limit on its sums, relative to each channel's magnitude:
    the float32 sums run in another order (per-CTA partials, then a fixed
    reduction over CTAs)."""
    return 1e-4 if dtype == torch.float32 else 1e-3


def stem_train_held(x, k, what):
    """Kernel C against stem_train_plain on one input: pools finite and, in
    float32, within 1e-5 of max|ĉ| plus 1e-5 relative (bf16: the v4 class);
    sums within `stem_train_sum_tol`.  Returns (pmax, {pool: (max error,
    bit-equal share)}, sums, the sums' relative error, max|ĉ|)."""
    from dcfa_yolo_tpu_torch.ops import cuda_stem_train as cst

    f32 = x.dtype == torch.float32
    pmax, pmin, sums = cst.stem_train(x, k)
    torch.cuda.synchronize()
    rmax, rmin, rsums = cst.stem_train_plain(x, k)
    c_max = max(rmax.float().abs().max().item(), rmin.float().abs().max().item())
    res = {}
    for name, o, r in (("pmax", pmax, rmax), ("pmin", pmin, rmin)):
        o, r = o.float(), r.float()
        err = (o - r).abs()
        frac = (o == r).float().mean().item()
        check(bool(torch.isfinite(o).all()), f"train stem {what} {name} not finite")
        if f32:
            check(bool(torch.all(err <= 1e-5 * c_max + 1e-5 * r.abs())),
                  f"train stem f32 {what} {name}: max err {err.max().item():.4g} "
                  f"(atol 1e-5·max|ĉ| = {1e-5 * c_max:.4g}, rtol 1e-5)")
        else:
            check(bool(torch.all(err <= 0.03 + 0.02 * r.abs())) and frac >= 0.999,
                  f"train stem {what} {name}: {frac:.6f} bit-equal (need 0.999), max "
                  f"err {err.max().item():.4g} (atol 0.03, rtol 0.02)")
        res[name] = (err.max().item(), frac)
    sum_err = ((sums - rsums).abs()
               / rsums.abs().clamp_min(1e-3 * rsums.abs().max())).max().item()
    sum_tol = stem_train_sum_tol(x.dtype)
    check(sum_err <= sum_tol, f"train stem {what} sums: relative error {sum_err:.3g} "
          f"> {sum_tol:g}")
    return pmax, res, sums, sum_err, c_max


def phase_train_stem(dev, dtype=torch.bfloat16):
    """Kernel C vs stem_train_plain at the edge shapes of its persistent
    tile walk and at the train path's shape (b16 640², one modality), on
    seeded NHWC images in [0, 1], with the sums of two launches bit-equal;
    then the differentiable `fused_train_stem` (γ of mixed signs, so the
    min pool is used) against the plain decomposition `reference_stem`.
    bf16: pools in the v4 class, sums within 1e-3 relative.  float32 (TF32
    off): pools within 1e-5 of max|ĉ| plus 1e-5 relative, sums within 1e-4
    relative, y within 1e-4 of max|y| and the moments at rtol 1e-4; only
    summation orders differ."""
    import torch.nn.functional as F
    from dcfa_yolo_tpu_torch.ops import cuda_stem_train as cst
    from dcfa_yolo_tpu_torch.utils.profiling import (H100_BF16_FLOPS, H100_FP32_FLOPS,
                                                     bound, device_ms)

    f32 = dtype == torch.float32
    tag = "[train_stem_f32]" if f32 else "[train_stem]"
    b, h, w = 16, 640, 640
    rng = np.random.default_rng(SEED + (31 if f32 else 30))
    x = torch.from_numpy(rng.random((b, h, w, 3), np.float32)).to(dev, dtype)
    k32 = torch.from_numpy((rng.standard_normal((16, 3, 3, 3)) * 0.3).astype(np.float32)).to(dev)
    k = k32.to(dtype)
    gamma = torch.from_numpy((rng.standard_normal(16)).astype(np.float32)).to(dev)
    beta = torch.from_numpy((rng.standard_normal(16) * 0.1).astype(np.float32)).to(dev)
    check(bool((gamma < 0).any() and (gamma > 0).any()), "γ needs both signs")

    sum_tol = stem_train_sum_tol(dtype)
    held = stem_train_held

    # the shapes the persistent tile walk can get wrong, pools and sums
    for sb, sh, sw in EDGE_SHAPES:
        xe = torch.from_numpy(rng.random((sb, sh, sw, 3), np.float32)).to(dev, dtype)
        held(xe, k, f"{sb}x{sh}x{sw}")
    print(f"{tag} pools and sums against stem_train_plain at {len(EDGE_SHAPES)} edge "
          f"shapes: held")
    pmax, res, sums, sum_err, c_max = held(x, k, f"b{b}")
    again = cst.stem_train(x, k)[2]
    check(torch.equal(again, sums), f"train stem sums differ between two launches: max "
          f"{(again - sums).abs().max().item():.3g}")

    y, mean, var = cst.fused_train_stem(x, k32, gamma, beta, 1e-5)
    y_ref, mean_ref, var_ref = cst.reference_stem(x, k32, gamma, beta, 1e-5)
    yd = (y.float() - y_ref.float()).abs()
    y_frac = (yd == 0).float().mean().item()
    if f32:
        y_tol = 1e-4 * y_ref.abs().max().item()
        check(yd.max().item() <= y_tol, f"fused_train_stem f32 vs reference_stem: "
              f"max err {yd.max().item():.4g} > 1e-4·max|y| = {y_tol:.4g}")
        check(bool(torch.allclose(mean, mean_ref, rtol=1e-4, atol=0)
                   and torch.allclose(var, var_ref, rtol=1e-4, atol=0)),
              "fused_train_stem f32 batch moments disagree with reference_stem (rtol 1e-4)")
    else:
        check(bool(torch.all(yd <= 0.03 + 0.02 * y_ref.float().abs())) and y_frac >= 0.99,
              f"fused_train_stem vs reference_stem: {y_frac:.6f} bit-equal (need 0.99), "
              f"max err {yd.max().item():.4g}")
        check(bool(torch.allclose(mean, mean_ref, rtol=1e-3, atol=1e-4)
                   and torch.allclose(var, var_ref, rtol=1e-3, atol=1e-4)),
              "fused_train_stem batch moments disagree with reference_stem")

    xc = x.permute(0, 3, 1, 2)  # NCHW view, channels_last strides

    def library():
        c = F.conv2d(xc, k, padding=1)
        cf = c.float()
        return (F.max_pool2d(c, 3, 2, 1), -F.max_pool2d(-c, 3, 2, 1),
                cf.sum((0, 2, 3)), (cf * cf).sum((0, 2, 3)))

    # what the function must move: the input, both pools, the weights and
    # the (16, 2) float32 sums; the kernel's per-CTA partials are its own
    es = x.element_size()
    nbytes = x.numel() * es + 2 * pmax.numel() * es + k.numel() * es + sums.numel() * 4
    bound_ms, bound_by = bound(nbytes, 2 * b * h * w * 16 * 27,
                               H100_FP32_FLOPS if f32 else H100_BF16_FLOPS)
    t = dict(max_abs_err=max(res["pmax"][0], res["pmin"][0]),
             ms=device_ms(lambda: cst.stem_train(x, k), 20),
             plain_ms=device_ms(lambda: cst.stem_train_plain(x, k), 5),
             library_ms=device_ms(library, 20), bound_ms=bound_ms, bound_by=bound_by)
    print(f"{tag} b{b} 640² {str(dtype)[6:]}: pmax bit-equal {res['pmax'][1]:.6f}, pmin "
          f"{res['pmin'][1]:.6f}, max_abs_err {t['max_abs_err']:.4g} (max|ĉ| {c_max:.4g}), "
          f"sums rel err {sum_err:.3g} (tol {sum_tol:g}) | fused y vs reference: "
          f"{y_frac:.6f} bit-equal, max err {yd.max().item():.4g} | kernel_ms "
          f"{t['ms']:.4f} plain_ms {t['plain_ms']:.4f} library_ms(cuDNN "
          f"conv+max/min pools+sums) {t['library_ms']:.4f} bound_ms {bound_ms:.5f} "
          f"({bound_by}, {nbytes / 1e6:.1f} MB) | {multiples(t)}; sums bit-equal over two "
          f"launches")
    return t


def phase_train(dev):
    """The train path: Trainer at phi='n' 640² bf16, b16 SGD-nesterov, the
    reference init (seed 0), 6 steps at a fixed LR on one batch, with the
    launch counts read around exactly those steps; then one step (forward,
    loss, backward) of the 'kernel' graph and one of the 'plain' graph from
    the same weights in bf16 and in float32, the counts read around those
    four: kernel against plain in bf16 (loss within 2%, stem-kernel
    gradient cosine ≥ 0.99) and in float32 (loss within 1e-4 relative,
    cosine ≥ 0.999); each graph's bf16 gradient against its float32 one
    leaf by leaf (the stem convs, the five lowest, the count below 0.99;
    reported); the stem conv weight gradients of the plain bf16 step
    (cuDNN's bf16 backward) against the float32 reduction of the same bf16
    operands rounded once (2 bf16 steps of the largest entry); and the
    bf16 matrix products of the kernel-graph step that run through cuBLAS,
    with `allow_bf16_reduced_precision_reduction`.  Returns kernel C's
    launches by entry."""
    from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
    from dcfa_yolo_tpu_torch.models.yolo import init_model
    from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem, cuda_stem_train
    from dcfa_yolo_tpu_torch.profile_train import step_stages, synthetic_batch
    from dcfa_yolo_tpu_torch.train.trainer import Trainer

    tc = TrainConfig()
    b, steps = tc.batch_size, 6
    lr = tc.scaled_lrs()[0]
    cfg = ModelConfig(num_classes=1, phi="n", input_shape=(640, 640),
                      compute_dtype="bfloat16")
    tr = Trainer(init_model(cfg, SEED, dev, train=True), tc, device=dev)
    print(f"[train] train_stem_backend {cfg.train_stem_backend!r} resolves to "
          f"{tr.train_stem!r}")
    check(tr.train_stem == "kernel", "the train stem resolved to the plain graph")
    host_batch = synthetic_batch(b, cfg.input_shape, tc.max_boxes, SEED + 40)
    batch = tr.put_batch(*host_batch)
    stem_bn = tr.model.backbone_rgb.stem.bn
    bn0 = (stem_bn.running_mean.clone(), stem_bn.running_var.clone())

    cuda_stem.LAUNCHES = cuda_nms.LAUNCHES = cuda_stem_train.LAUNCHES = 0
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        lb = tr.train_step(batch, lr)
        losses.append(float(lb.total))  # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    launches = {"stem_eval": cuda_stem.LAUNCHES, "nms_suppress": cuda_nms.LAUNCHES,
                "stem_train": cuda_stem_train.LAUNCHES}
    med = float(np.median(step_ms))
    print(f"[train] b{b} 640² bf16 SGD lr {lr:g}, {steps} steps on one batch: launches "
          f"{launches}, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"[train] ms/step median {med:.2f} (host clock, ends in a synchronise; "
          f"steps {', '.join(f'{t:.1f}' for t in step_ms)}), images/s {b * 1e3 / med:.1f}")
    check(launches["stem_train"] == 2 * steps,
          f"expected {2 * steps} train-stem launches, got {launches}")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(not torch.equal(stem_bn.running_mean, bn0[0])
          and not torch.equal(stem_bn.running_var, bn0[1]),
          "stem BN running statistics did not move")
    check(tr.ema.updates == steps, f"EMA counter {tr.ema.updates}, expected {steps}")
    ev = tr.eval_step(batch)
    check(all(bool(torch.isfinite(t)) for t in ev), "eval_step on the EMA weights not finite")
    print(f"[train] eval_step on the EMA weights: loss {float(ev.total):.4f} "
          f"(box {float(ev.box):.4f}, cls {float(ev.cls):.4f}, dfl {float(ev.dfl):.4f})")

    # one step split into its stages, a synchronise after each
    stages = step_stages(tr, batch, lr)
    print("[train] one step by stage (ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()) + f", sum {sum(stages.values()):.2f}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] peak device memory so far {peak:.2f} GiB")

    del tr, batch
    cuda_stem_train.LAUNCHES = cuda_stem_train.LAUNCHES_F32 = 0
    runs = one_step_runs(dev, cfg, tc, host_batch)
    torch.cuda.synchronize()
    launches["stem_train"] += cuda_stem_train.LAUNCHES - cuda_stem_train.LAUNCHES_F32
    launches["stem_train_f32"] = cuda_stem_train.LAUNCHES_F32
    check(launches["stem_train_f32"] == 2 and launches["stem_train"] == 2 * steps + 2,
          f"kernel C launches in the one-step comparisons: {launches}")
    report_one_step_runs(*runs)
    return launches


def one_step_runs(dev, cfg, tc, host_batch):
    """One step (forward, loss, backward) of the 'kernel' and of the 'plain'
    stem graph from the same weights (`cfg` with seed SEED), in bf16 and in
    float32: ({(dtype, graph): (loss, gradient leaves)}, the plain bf16
    step's stem conv taps, the kernel bf16 step's cuBLAS bf16 products)."""
    from dcfa_yolo_tpu_torch.models.yolo import init_model
    from dcfa_yolo_tpu_torch.train.trainer import Trainer

    steps = {}
    for dtype in ("bfloat16", "float32"):
        for backend in ("kernel", "plain"):
            c = dataclasses.replace(cfg, train_stem_backend=backend, compute_dtype=dtype)
            t = Trainer(init_model(c, SEED, dev, train=True), tc, device=dev)
            check(t.train_stem == backend, f"{backend!r} resolved to {t.train_stem!r}")
            bt = t.put_batch(*host_batch)
            named = [(n, p.detach()) for n, p in t._named]
            if (dtype, backend) == ("bfloat16", "kernel"):
                with GemmRecorder() as gemms:
                    loss, flat = one_step_grad(t, bt)
            elif (dtype, backend) == ("bfloat16", "plain"):
                with StemConvTap(t.model) as taps:
                    loss, flat = one_step_grad(t, bt)
            else:
                loss, flat = one_step_grad(t, bt)
            steps[(dtype, backend)] = (loss, grad_leaves(flat, named))
            del t, bt
    return steps, taps, gemms


def report_one_step_runs(steps, taps, gemms):
    """[train]'s checks and report on `one_step_runs` (`phase_train`)."""
    stems = tuple(f"backbone_{m}.stem.conv.weight" for m in ("rgb", "nir"))
    for dtype, loss_tol, cos_tol in (("bfloat16", 0.02, 0.99), ("float32", 1e-4, 0.999)):
        (lk, gk), (lp, gp) = steps[(dtype, "kernel")], steps[(dtype, "plain")]
        loss_rel = abs(lk - lp) / abs(lp)
        cos = [float(gk[n] @ gp[n] / (np.linalg.norm(gk[n]) * np.linalg.norm(gp[n])))
               for n in stems]
        print(f"[train] {dtype} kernel vs plain stem graph, one step from the same weights: "
              f"loss {lk:.6f} vs {lp:.6f} (rel {loss_rel:.3g}, tol {loss_tol:g}), stem "
              f"conv-kernel gradient cosine rgb {cos[0]:.7f} nir {cos[1]:.7f} (tol {cos_tol:g})")
        check(loss_rel <= loss_tol and min(cos) >= cos_tol,
              f"{dtype} kernel stem graph disagrees with the plain graph")
    for backend in ("kernel", "plain"):
        leaves = leaf_cosines(steps[("bfloat16", backend)][1], steps[("float32", backend)][1])
        zero = zero_leaves(leaves, 0.99)
        held = {n: v for n, v in leaves.items() if n not in zero}
        low = sorted(held, key=lambda n: held[n][0])[:5]
        print(f"[train] {backend} graph, bf16 gradient against float32 (TF32 off), leaf by "
              f"leaf: stem conv cosine rgb {leaves[stems[0]][0]:.7f} nir "
              f"{leaves[stems[1]][0]:.7f}; {sum(v[0] < 0.99 for v in held.values())} of "
              f"{len(held)} leaves below 0.99 ({len(zero)} zero in exact arithmetic left "
              f"out); lowest " + ", ".join(f"{n} {held[n][0]:.5f}" for n in low))
        check(all(np.isfinite(v[0]) for v in held.values()),
              f"[train] {backend}: a non-finite bf16 gradient cosine")
    check(set(taps) == {"rgb", "nir"}, f"[train] stem conv taps fired for {sorted(taps)}")
    for m, (x, g) in sorted(taps.items()):
        stem_wgrad_check(x, g, steps[("bfloat16", "plain")][1][f"backbone_{m}.stem.conv.weight"],
                         m)
    print(f"[train] torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}; bf16 "
          f"matrix products through cuBLAS in one kernel-graph step: "
          + (", ".join(f"{k} ×{v}" for k, v in sorted(gemms.counts.items())) or "none"))


def phase_remat(dev):
    """Backbone rematerialization (`ModelConfig.remat`, `torch.utils.
    checkpoint`) on the train path: phi='n' 640², [train]'s init (seed 0) and
    optimizer, kernel C in both stems, one seeded b16 batch.  One step with
    and one without remat from the same weights, with deterministic cuDNN,
    in float32 and in bf16: the loss terms, every gradient leaf and the BN
    running statistics `torch.equal`.
    Kernel C launches 4 times a step with remat (the forward and the
    backward's recompute, both stems; the backward itself differentiates
    the plain decomposition) and 2 without.  Then peak device memory and
    step ms with and without remat in bf16 at b16 and b128, and at b64 if
    b128 does not fit without remat.  Returns kernel C's launches by
    entry."""
    import gc

    from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
    from dcfa_yolo_tpu_torch.models.yolo import init_model
    from dcfa_yolo_tpu_torch.ops import cuda_stem_train
    from dcfa_yolo_tpu_torch.profile_train import synthetic_batch
    from dcfa_yolo_tpu_torch.train.trainer import Trainer

    tc = TrainConfig()
    lr = tc.scaled_lrs()[0]
    base = ModelConfig(num_classes=1, phi="n", input_shape=(640, 640),
                       train_stem_backend="kernel")
    host = synthetic_batch(16, (640, 640), tc.max_boxes, SEED + 140)
    launches = {"stem_train": 0, "stem_train_f32": 0}

    def trainer(dtype, remat):
        t = Trainer(init_model(dataclasses.replace(base, compute_dtype=dtype, remat=remat),
                               SEED, dev, train=True), tc, device=dev)
        check(t.train_stem == "kernel", f"remat={remat} {dtype}: stem {t.train_stem!r}")
        return t

    def counted(fn):
        torch.cuda.synchronize()
        cuda_stem_train.LAUNCHES = cuda_stem_train.LAUNCHES_F32 = 0
        out = fn()
        torch.cuda.synchronize()
        n = cuda_stem_train.LAUNCHES
        launches["stem_train"] += n - cuda_stem_train.LAUNCHES_F32
        launches["stem_train_f32"] += cuda_stem_train.LAUNCHES_F32
        return out, n

    def one_step(dtype, remat):
        t = trainer(dtype, remat)
        b = t.put_batch(*host)
        (lb, g), n = counted(lambda: t.step_with_grad(b, lr))
        return dict(terms=torch.stack(list(lb)), grad=g, launches=n, named=list(t._named),
                    stats={k: v.clone() for k, v in t.state.batch_stats.items()})

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        f32 = {r: one_step("float32", r) for r in (False, True)}
        bf16 = {r: one_step("bfloat16", r) for r in (False, True)}
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    for dtype, runs in (("float32", f32), ("bfloat16", bf16)):
        a, r = runs[False], runs[True]
        same = dict(loss=torch.equal(a["terms"], r["terms"]),
                    grad=torch.equal(a["grad"], r["grad"]),
                    stats=all(torch.equal(v, r["stats"][k]) for k, v in a["stats"].items()))
        leaves = leaf_cosines(grad_leaves(r["grad"].cpu().numpy(), a["named"]),
                              grad_leaves(a["grad"].cpu().numpy(), a["named"]))
        stem_cos = min(leaves[f"backbone_{m}.stem.conv.weight"][0] for m in ("rgb", "nir"))
        loss_rel = abs(float(r["terms"][0] - a["terms"][0])) / abs(float(a["terms"][0]))
        print(f"[remat] {dtype} b16 640², one step with vs without remat from the same "
              f"weights: loss {float(r['terms'][0]):.6f} vs {float(a['terms'][0]):.6f} (rel "
              f"{loss_rel:.3g}); torch.equal loss terms {same['loss']}, flat gradient "
              f"{same['grad']}, BN running statistics {same['stats']}; stem conv cosine "
              f"{stem_cos:.7f}; kernel C launches a step {r['launches']} with, "
              f"{a['launches']} without; deterministic cuDNN")
        check(r["launches"] == 4 and a["launches"] == 2,
              f"[remat] {dtype}: kernel C launched {r['launches']} / {a['launches']} times a "
              "step with / without remat, expected 4 / 2")
        check(all(same.values()), f"[remat] {dtype} step with remat differs: {same}")
    del f32, bf16

    def measure(b, remat, steps=2):
        """Peak memory (GiB) and median step ms (host clock, each step ending
        in a synchronise) of bf16 steps at batch b, None if it does not fit."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            t = trainer("bfloat16", remat)
            bt = t.put_batch(*(np.concatenate([a] * (b // 16)) for a in host))
            ms = []
            for _ in range(steps + 1):
                t0 = time.perf_counter()
                counted(lambda: t.train_step(bt, lr))
                ms.append((time.perf_counter() - t0) * 1e3)
            return torch.cuda.max_memory_allocated() / 2**30, float(np.median(ms[1:]))
        except torch.cuda.OutOfMemoryError:
            return None

    sizes = {}
    for b in (16, 128):
        sizes[b] = {r: measure(b, r) for r in (False, True)}
    if sizes[128][False] is None:
        sizes[64] = {r: measure(64, r) for r in (False, True)}
    gc.collect()
    torch.cuda.empty_cache()
    fmt = lambda m: ("does not fit (out of memory)" if m is None
                     else f"peak {m[0]:.2f} GiB, {m[1]:.1f} ms/step")
    for b, res in sizes.items():
        print(f"[remat] bf16 b{b} 640²: without remat {fmt(res[False])}; with remat "
              f"{fmt(res[True])} (peak torch.cuda.max_memory_allocated; median of 2 steps "
              f"after one, host clock) | {CARD}")
        check(res[True] is not None, f"[remat] b{b} does not fit even with remat")
    return launches


def train_data(n):
    """`n` synthetic 480×360 PNG pairs (`tools/make_synth_dataset.py`) split
    3:1 into train and val annotation files (`data/voc.py`): (directory,
    classes file, train file, val file)."""
    import tempfile

    from dcfa_yolo_tpu_torch.data import voc
    from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    make_dataset(tmp, n)
    devkit = os.path.join(tmp, "VOCdevkit")
    voc.generate_imagesets(devkit, trainval_percent=1.0, train_percent=0.75)
    classes = os.path.join(tmp, "model_data", "voc_classes.txt")
    voc.generate_annotation_files(devkit, classes, out_dir=tmp, image_ext=".png")
    return (tmp, classes, os.path.join(tmp, "2007_train.txt"),
            os.path.join(tmp, "2007_val.txt"))


def read_lines(path):
    with open(path) as f:
        return [l.strip() for l in f if l.strip()]


def aug_fixed_params(ds):
    """Four fixed samples of `data/device_aug.py`'s program at 640²: a mosaic
    with pre-flips and HSV gains, a post-flipped plain sample, a mixup with a
    post-flipped partner, and a val letterbox."""
    from dcfa_yolo_tpu_torch.data.device_aug import GeomParams, ParamSampler

    p = GeomParams(idx=np.zeros((4, 5), np.int32), mode=np.zeros(4, np.float32),
                   mix=np.zeros(4, np.float32), preflip=np.zeros((4, 5), np.float32),
                   postflip=np.zeros((4, 5), np.float32), nw=np.ones((4, 5), np.float32),
                   nh=np.ones((4, 5), np.float32), dx=np.full((4, 5), -4.0, np.float32),
                   dy=np.full((4, 5), -4.0, np.float32), cut=np.zeros((4, 2), np.float32),
                   hsv=np.ones((4, 3), np.float32))

    def geom(row, slot, g):
        p.nw[row, slot], p.nh[row, slot], p.dx[row, slot], p.dy[row, slot] = g

    p.mode[0], p.cut[0], p.hsv[0] = 1.0, (301, 277), (1.06, 0.55, 1.3)
    p.idx[0, :4], p.preflip[0, :4] = (3, 7, 11, 13), (1, 0, 1, 1)
    for s, g in enumerate([(340, 300, -39, -23), (410, 450, -109, 277),
                           (455, 402, 301, 277), (380, 330, 301, -53)]):
        geom(0, s, g)
    p.idx[1], p.postflip[1, 0] = 5, 1.0
    geom(1, 0, (600, 470, 17, 60))
    p.idx[2], p.idx[2, 4], p.mix[2], p.postflip[2, 4] = 9, 21, 1.0, 1.0
    geom(2, 0, (520, 430, 40, 100))
    geom(2, 4, (800, 700, -90, -50))
    val = ParamSampler(ds, (640, 640), train=False).sample(
        np.random.Generator(np.random.PCG64(0)), np.array([17]))
    for f, v in zip(p, val):
        f[3] = v[0]
    return p


def phase_device_aug(dev, data):
    """Augmentation on the card (`data/device_aug.py`): the 32 synthetic
    480×360 pairs of [train_cli] staged at 640², b16 parameters from
    `ParamSampler` (epoch 0, the CLI's probabilities) and four fixed samples
    (`aug_fixed_params`).
      * float32 on the card against the same program on the CPU: pixels
        within 2e-5 on the [0, 1] output, boxes, labels and masks equal;
      * bf16 resampling against float32 on the card: boxes, labels and masks
        bit-equal; pixels (in uint8 steps) reported, and held against the
        same bf16 arithmetic through float32 GEMMs on the card (the same
        products, other summation orders): mean within 0.01 of a step (a
        bf16-rounded second contraction would add about 0.1);
      * the JAX module's own figure's setting (`tools/bench_device_aug.py`'s
        32 random tiles, mosaic and mixup on every sample, b16): bf16 against
        float32 pixels p99 ≤ 0.3 of a step, and max ≤ 1.0 with the HSV gains
        at 1 (the hue gain is discontinuous at red, where h·r mod 180 jumps:
        a sub-step difference moves a pixel across it);
    then `tools/bench_device_aug.py` on the staged pairs: the host loader's
    float32 batch copy, the program in float32 and bf16, the augment +
    train-step chain (b16, bf16 model)."""
    from dcfa_yolo_tpu_torch.data import device_aug as da
    from dcfa_yolo_tpu_torch.tools.bench_device_aug import random_staged
    from dcfa_yolo_tpu_torch.tools.bench_device_aug import run as bench_aug

    _, _, train_file, val_file = data
    lines = read_lines(train_file) + read_lines(val_file)
    t0 = time.perf_counter()
    ds = da.stage_pairs(lines, (640, 640), 64)
    stage_s = time.perf_counter() - t0
    smp = da.ParamSampler(ds, (640, 640))
    smp.set_epoch(0)
    sampled = smp.sample(np.random.Generator(np.random.PCG64(SEED + 150)), np.arange(16))
    print(f"[device_aug] {len(lines)} pairs staged at 640² in {stage_s:.2f} s "
          f"({ds.images.nbytes / 1e6:.0f} MB); b16 sample: {int(sampled.mode.sum())} mosaic, "
          f"{int(sampled.mix.sum())} mixup")
    f32 = da.make_device_augment((640, 640), 64)
    bf16 = da.make_device_augment((640, 640), 64, resample_dtype=torch.bfloat16)

    def call(prog, staged, p, device):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return [x.float().cpu() for x in prog(t(staged.images), t(staged.boxes),
                                              t(staged.nbox), t(p.idx),
                                              da.GeomParams(*(t(x) for x in p)))]

    def lsb(a, b):
        d = ((a - b).abs() * 255).numpy()
        return float(np.percentile(d, 99)), float(d.max()), float(d.mean()), int((d > 1).sum())

    boxes_equal = lambda a, b: all(torch.equal(x, y) for x, y in zip(a[2:], b[2:]))
    for name, p in (("b16 sampled", sampled), ("fixed", aug_fixed_params(ds))):
        card = call(f32, ds, p, dev)
        cpu = call(f32, ds, p, "cpu")
        err = max(float((a - b).abs().max()) for a, b in zip(card[:2], cpu[:2]))
        check(all(bool(torch.isfinite(x).all()) for x in card), f"[device_aug] {name}: not finite")
        print(f"[device_aug] {name}: float32 card vs CPU max {err:.3g} on [0, 1] (tol 2e-5); "
              f"boxes, labels and masks equal {boxes_equal(card, cpu)}")
        check(err <= 2e-5 and boxes_equal(card, cpu),
              f"[device_aug] {name}: float32 card vs CPU pixels {err:.3g} (tol 2e-5), boxes "
              f"equal {boxes_equal(card, cpu)}")
        half = call(bf16, ds, p, dev)
        with_f32_gemm = da._contract
        da._contract = lambda a, b: torch.bmm(a.float(), b.float())
        try:
            emul = call(bf16, ds, p, dev)
        finally:
            da._contract = with_f32_gemm
        vs32, vsem = (lsb(torch.cat(half[:2]), torch.cat(x[:2])) for x in (card, emul))
        print(f"[device_aug] {name}: bf16 vs float32 (uint8 steps): p99 {vs32[0]:.4f} "
              f"max {vs32[1]:.4f} mean {vs32[2]:.4f}, {vs32[3]} pixels above 1; boxes equal "
              f"{boxes_equal(half, card)} | bf16 vs its arithmetic in float32 GEMMs: p99 "
              f"{vsem[0]:.4f} max {vsem[1]:.4f} mean {vsem[2]:.5f} (tol 0.01)")
        check(boxes_equal(half, card), f"[device_aug] {name}: bf16 boxes differ from float32")
        check(vsem[2] <= 0.01, f"[device_aug] {name}: bf16 vs its float32-GEMM arithmetic "
              f"mean {vsem[2]:.4f} steps")

    rnd = random_staged(32, 640)
    rsmp = da.ParamSampler(rnd, (640, 640), mosaic_prob=1.0, mixup_prob=1.0, epoch_length=100)
    rsmp.set_epoch(0)
    rp = rsmp.sample(np.random.Generator(np.random.PCG64(0)), np.arange(16))
    out = {}
    for gains in ("drawn", "identity"):
        q = rp if gains == "drawn" else rp._replace(hsv=np.ones_like(rp.hsv))
        a, b = call(f32, rnd, q, dev), call(bf16, rnd, q, dev)
        out[gains] = lsb(torch.cat(b[:2]), torch.cat(a[:2]))
        check(boxes_equal(a, b), f"[device_aug] random tiles, HSV {gains}: boxes differ")
    print(f"[device_aug] random tiles (tools/bench_device_aug.py's), b16 mosaic + mixup, bf16 "
          f"vs float32 (uint8 steps): HSV gains drawn p99 {out['drawn'][0]:.4f} (tol 0.3) max "
          f"{out['drawn'][1]:.4f}; at 1 p99 {out['identity'][0]:.4f} max "
          f"{out['identity'][1]:.4f} (tol 1.0); boxes equal")
    check(out["drawn"][0] <= 0.3 and out["identity"][1] <= 1.0,
          "[device_aug] bf16 resampling off the JAX figure's limits on random tiles")

    res = bench_aug(annotation=train_file, batch_size=16, size=640, iters=10, device=dev)
    print(f"[device_aug] bench (b16 640², {res['pairs']} train pairs, mosaic + mixup on every "
          f"sample): host float32 batch copy {res['host_copy_ms']:.3f} ms "
          f"({res['host_batch_mb']:.0f} MB, {res['host_copy_gb_per_s']:.2f} GB/s); program "
          f"float32 {res['aug_ms']['float32']:.3f} ms, bf16 {res['aug_ms']['bfloat16']:.3f} ms "
          f"a batch; augment + train step (bf16) {res['aug_train_step_ms']:.2f} ms = "
          f"{res['aug_train_images_per_s']:.1f} images/s (CUDA events) | {CARD}")
    print(json.dumps({"device_aug_bench": res}))
    check(res["train_stem"] == "kernel", f"bench chain stem {res['train_stem']!r}")


def phase_train_cli(dev, data):
    """The training CLI (`python -m dcfa_yolo_tpu_torch.train`) in-process
    at phi='n' 640² float32, full width, `--train-stem pallas`, fold-shuffle,
    mosaic and mixup on (the defaults), on a 32-pair synthetic dataset
    (`train_data`: 480×360 PNG pairs, 24 train / 8 val): 2 epochs with mAP
    at epoch 2, then `--resume` from the last checkpoint for a third.  Launch
    counts are read around each run; a checkpoint must load into the
    unfolded graph and compute the folded EMA model's eval forward
    (tests/test_torch_model.py's float32 tolerances).  Then one epoch with
    `--device-aug --remat` (mAP off): finite losses, 4 float32 kernel C
    launches a step (the forward and the recompute), and no
    `Trainer.put_batch` call; its step p50 beside the host loader's."""
    import tempfile

    from dcfa_yolo_tpu_torch.config import ModelConfig
    from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo
    from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem, cuda_stem_train
    from dcfa_yolo_tpu_torch.train.__main__ import run
    from dcfa_yolo_tpu_torch.train.trainer import Trainer
    from dcfa_yolo_tpu_torch.utils.checkpoint import load_checkpoint, load_variables

    def reset():
        cuda_stem.LAUNCHES = cuda_nms.LAUNCHES = 0
        cuda_stem_train.LAUNCHES = cuda_stem_train.LAUNCHES_F32 = 0

    def counts():
        torch.cuda.synchronize()
        return {"stem_train_f32": cuda_stem_train.LAUNCHES_F32,
                "stem_train": cuda_stem_train.LAUNCHES,
                "stem_eval": cuda_stem.LAUNCHES, "nms_suppress": cuda_nms.LAUNCHES}

    lines = read_lines

    def tf32():
        return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    # the CLI sets its own precision: start it from PyTorch's defaults, as a
    # fresh process would, not from this script's TF32-off setting
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    _, classes, train_file, val_file = data
    with tempfile.TemporaryDirectory() as tmp:
        n_train, n_val = len(lines(train_file)), len(lines(val_file))
        print(f"[train_cli] synthetic dataset: {n_train} train + {n_val} val pairs, "
              f"480×360 PNG")
        common = ["--classes-path", classes,
                  "--train-annotation", train_file, "--val-annotation", val_file,
                  "--input-shape", "640", "640", "--phi", "n",
                  "--compute-dtype", "float32", "--train-stem", "pallas",
                  "--batch-size", "8", "--save-period", "1", "--eval-period", "2",
                  "--num-workers", "4", "--save-dir", os.path.join(tmp, "logs"),
                  "--seed", str(SEED), "--device", str(dev)]
        reset()
        t0 = time.perf_counter()
        r1 = run(common + ["--unfreeze-epoch", "2"])
        wall1 = time.perf_counter() - t0
        n1 = counts()
        tf32_1 = tf32()
        steps1 = sum(e["steps"] for e in r1["epochs"])
        last = os.path.join(r1["log_dir"], "last_epoch_weights.ckpt")
        saved = load_checkpoint(last)
        reset()
        t0 = time.perf_counter()
        r2 = run(common + ["--unfreeze-epoch", "3", "--resume", last])
        wall2 = time.perf_counter() - t0
        n2 = counts()
        tf32_2 = tf32()
        steps2 = sum(e["steps"] for e in r2["epochs"])
        epochs = r1["epochs"] + r2["epochs"]
        for e in epochs:
            tm = e["timing"]
            print(f"[train_cli] epoch {e['epoch']}: {e['steps']} steps, loss {e['loss']:.4f}, "
                  f"val_loss {e['val_loss']:.4f}, mAP {e['map']} | ms/step mean "
                  f"{tm['mean_ms']:.2f} p50 {tm['p50_ms']:.2f} p95 {tm['p95_ms']:.2f} "
                  f"(CUDA events around each step) | loader capacity "
                  f"{e['loader_capacity']:.3f} batches/s, waited {e['fetch_wait_s']:.2f} s on data "
                  f"| {CARD}")
        print(f"[train_cli] run 1 (epochs 1-2): launches {n1}, {steps1} steps, {wall1:.1f} s; "
              f"run 2 (--resume, epoch 3): launches {n2}, {steps2} steps, {wall2:.1f} s; "
              f"TF32 (cudnn, matmul) set by the CLI: {tf32_1}, {tf32_2}")
        check(tf32_1 == tf32_2 == (False, False),
              f"--compute-dtype float32 left TF32 on: {tf32_1}, {tf32_2}")
        check(steps1 == 2 * (n_train // 8) and steps2 == n_train // 8,
              f"train steps {steps1} + {steps2}, expected {n_train // 8} an epoch")
        check(n1["stem_train_f32"] == 2 * steps1 == n1["stem_train"]
              and n2["stem_train_f32"] == 2 * steps2 == n2["stem_train"],
              f"expected 2 float32 train-stem launches a step, got {n1} and {n2}")
        check(n1["nms_suppress"] > 0, f"the eval epoch launched no NMS kernel: {n1}")
        check(all(np.isfinite([e["loss"], e["val_loss"]]).all() for e in epochs),
              "non-finite CLI losses")
        check(epochs[1]["map"] is not None and np.isfinite(epochs[1]["map"]),
              "no mAP at the eval epoch")
        logs = sorted({r1["log_dir"], r2["log_dir"]})
        n_loss = sum(len(lines(os.path.join(d, "epoch_loss.txt"))) for d in logs)
        check(n_loss == 3, f"epoch_loss.txt holds {n_loss} lines across the runs, expected 3")
        maps = lines(os.path.join(r1["log_dir"], "epoch_map.txt"))
        check(len(maps) >= 2 and abs(float(maps[1]) - epochs[1]["map"]) <= 1e-6,
              f"epoch_map.txt lacks the eval line: {maps}")
        names = set(os.listdir(r1["log_dir"])) | set(os.listdir(r2["log_dir"]))
        for want in ("ep001-", "ep002-", "ep003-", "best_epoch_weights.ckpt",
                     "last_epoch_weights.ckpt"):
            check(any(n.startswith(want) for n in names), f"no checkpoint {want}*")
        check(r2["init_epoch"] == 2 and r2["ema_updates_at_start"] == saved["ema_updates"]
              == steps1, f"resume started at epoch {r2['init_epoch'] + 1} with "
              f"ema_updates {r2['ema_updates_at_start']} (saved {saved['ema_updates']})")

        # the last checkpoint, unfolded graph, against the trainer's folded EMA model
        cfg = ModelConfig(num_classes=1, phi="n", input_shape=(640, 640))
        plain = DCFAYolo(cfg)
        plain.load_state_dict(load_variables(os.path.join(r2["log_dir"],
                                                          "last_epoch_weights.ckpt")))
        folded = DCFAYolo(cfg, fold_shuffle=True)
        folded.load_state_dict(r2["trainer"].state.ema)
        rng = np.random.default_rng(SEED + 60)
        x = torch.from_numpy(rng.random((2, 640, 640, 3), np.float32)).to(dev)
        y = torch.from_numpy(rng.random((2, 640, 640, 3), np.float32)).to(dev)
        with torch.no_grad():
            op = plain.to(dev).eval()(x, y)
            of = folded.to(dev).eval()(x, y)
        errs = {}
        for name, a, b, (rtol, atol) in (
                [("dbox", op.dbox, of.dbox, (1e-3, 5e-4)), ("cls", op.cls, of.cls, (1e-3, 2e-4))]
                + [(f"feat{i}", fa, fb, (1e-3, 2e-4))
                   for i, (fa, fb) in enumerate(zip(op.feats, of.feats))]):
            errs[name] = (a - b).abs().max().item()
            check(bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
                  f"checkpoint in the unfolded graph vs folded EMA model: {name} max err "
                  f"{errs[name]:.3g} (rtol {rtol:g}, atol {atol:g})")
        print("[train_cli] last checkpoint in the unfolded graph vs the folded EMA model, "
              "eval forward b2: max |Δ| " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
        del r1, r2, plain, folded, op, of

        # one epoch with the dataset staged on the card and remat
        puts = []
        real_put = Trainer.put_batch
        Trainer.put_batch = lambda self, *a: puts.append(1) or real_put(self, *a)
        reset()
        try:
            t0 = time.perf_counter()
            r3 = run(common + ["--unfreeze-epoch", "1", "--no-eval", "--device-aug",
                               "--remat"])
            wall3 = time.perf_counter() - t0
        finally:
            Trainer.put_batch = real_put
        n3 = counts()
        e3 = r3["epochs"][0]
        host_p50 = [e["timing"]["p50_ms"] for e in epochs]
        print(f"[train_cli] --device-aug --remat, epoch 1: {e3['steps']} steps, loss "
              f"{e3['loss']:.4f}, val_loss {e3['val_loss']:.4f} | ms/step p50 "
              f"{e3['timing']['p50_ms']:.2f} mean {e3['timing']['mean_ms']:.2f} (host loader "
              f"runs, epochs 1-3: p50 {', '.join(f'{t:.2f}' for t in host_p50)}) | waited "
              f"{e3['fetch_wait_s']:.2f} s on data | launches {n3}, put_batch calls "
              f"{len(puts)}, {wall3:.1f} s | {CARD}")
        check(np.isfinite([e3["loss"], e3["val_loss"]]).all(), "--device-aug CLI loss not finite")
        check(e3["steps"] == n_train // 8 and n3["stem_train_f32"] == 4 * e3["steps"]
              == n3["stem_train"], f"--device-aug --remat: expected 4 float32 kernel C "
              f"launches a step over {n_train // 8} steps, got {n3} in {e3['steps']} steps")
        check(not puts, f"--device-aug called Trainer.put_batch {len(puts)} times")
        check(r3["trainer"].model.cfg.remat, "--remat did not reach the model")
        del r3
        n4 = train_cli_pretrained(common, tmp, n_train, epochs, reset, counts)
    return {"stem_train_f32": n1["stem_train_f32"] + n2["stem_train_f32"]
            + n3["stem_train_f32"] + n4["stem_train_f32"]}


def train_cli_pretrained(common, tmp, n_train, host_epochs, reset, counts):
    """[pretrained]: the training CLI with `--pretrained --model-dir D` on
    [train_cli]'s dataset and arguments, one epoch, mAP off.  D holds a
    phi-n backbone file synthesized from the golden manifest (its
    `backbone_rgb.*` entries, unprefixed, `torch.save`d as the reference's
    release file).  The weights the trainer holds when its first step
    starts (read by a hook on `Trainer.train_step`, unfolded from the
    `--fold-shuffle` space) must have both backbones equal to the file bit
    for bit and the head's BN scales exactly 1.0 (the JAX model's initial
    state); the losses finite; 2 float32 kernel C launches a step."""
    from dcfa_yolo_tpu_torch.models.reparam import unfold_shuffle_state_dict
    from dcfa_yolo_tpu_torch.models.torch_import import reference_key_to_port
    from dcfa_yolo_tpu_torch.train.__main__ import run
    from dcfa_yolo_tpu_torch.train.trainer import Trainer
    from dcfa_yolo_tpu_torch.utils import golden

    here = os.path.dirname(os.path.abspath(__file__))
    manifest = golden.load_manifest(os.path.join(here, "tests", "goldens", "manifest.json"))
    bb = {k[len("backbone_rgb."):]: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in golden.synth_state_dict(manifest, SEED).items()
          if k.startswith("backbone_rgb.")}
    model_dir = os.path.join(tmp, "pretrained")
    os.makedirs(model_dir)
    torch.save(bb, os.path.join(model_dir, "yolov8_n_backbone_weights.pth"))

    seen = []
    real_step = Trainer.train_step

    def first_step(self, *a, **k):
        if not seen:
            st = self.state
            sd = {n: t.detach().cpu().clone()
                  for n, t in {**st.params, **st.batch_stats}.items()}
            seen.append(unfold_shuffle_state_dict(sd) if self.model.fold_shuffle else sd)
        return real_step(self, *a, **k)

    Trainer.train_step = first_step
    try:
        reset()
        t0 = time.perf_counter()
        r = run(common + ["--unfreeze-epoch", "1", "--no-eval", "--pretrained",
                          "--model-dir", model_dir])
        wall = time.perf_counter() - t0
    finally:
        Trainer.train_step = real_step
    n = counts()
    (e,) = r["epochs"]
    init = r["init"]
    check(len(seen) == 1, "--pretrained: the first-step hook did not run")
    (initial,) = seen
    unequal = [(branch, k) for k, v in bb.items() if not k.endswith("num_batches_tracked")
               for branch in ("backbone_rgb", "backbone_nir")
               if not torch.equal(initial[reference_key_to_port(f"{branch}.{k}")], v.float())]
    head_scales = [k for k, v in initial.items() if not k.startswith("backbone_")
                   and k.endswith(".bn.weight")]
    not_one = [k for k in head_scales if not bool((initial[k] == 1.0).all())]
    caps = [h["loader_capacity"] for h in host_epochs]
    print(f"[pretrained] {init['path'].rsplit(os.sep, 1)[-1]} ({len(bb)} keys): "
          f"{len(init['matched'])} tensors into both branches, {len(init['skipped'])} "
          f"skipped; the trainer's backbones at step 1 bit-equal to the file: "
          f"{not unequal}; {len(head_scales)} head BN scales exactly 1.0: {not not_one}")
    print(f"[pretrained] epoch 1: {e['steps']} steps, loss {e['loss']:.4f}, val_loss "
          f"{e['val_loss']:.4f} | launches {n}, {wall:.1f} s | loader capacity "
          f"{e['loader_capacity']:.3f} batches/s (epochs 1-3 above: "
          f"{', '.join(f'{c:.3f}' for c in caps)}), waited {e['fetch_wait_s']:.2f} s on data "
          f"| {CARD}")
    check(init["source"] == "pretrained" and len(init["matched"]) == 2 * sum(
        not k.endswith("num_batches_tracked") for k in bb),
          f"--pretrained imported {len(init['matched'])} tensors from {len(bb)} keys")
    check(not unequal, f"backbones differ from the file at step 1: {unequal[:4]}")
    check(head_scales and not not_one, f"head BN scales not at 1.0: {not_one[:4]}")
    check(np.isfinite([e["loss"], e["val_loss"]]).all(), "--pretrained CLI loss not finite")
    check(e["steps"] == n_train // 8 and n["stem_train_f32"] == 2 * e["steps"]
          == n["stem_train"], f"--pretrained: expected 2 float32 kernel C launches a step "
          f"over {n_train // 8} steps, got {n} in {e['steps']} steps")
    del r
    return n


def phase_probe(dev):
    """The stem split probe at b16 640²: its entry point, with the launch
    counts read around exactly that run; then each variant, all four on
    kernel A's core, against its plain version (pool exactly, the others in
    the v4 class); conv under full exactly (relu(conv) <= full: its values
    are the window centres A pools); dblbuf, kernel A's own code, and pipe,
    A's conv step and pool split between warps, bit-identical to full.
    Prints the split: (conv + pool) / full, pool / full and pipe / full."""
    import torch.nn.functional as F
    from dcfa_yolo_tpu_torch.ops import cuda_stem
    from dcfa_yolo_tpu_torch.ops import cuda_stem_probe as csp
    from dcfa_yolo_tpu_torch.tools import stem_split_probe as probe
    from dcfa_yolo_tpu_torch.utils.profiling import device_ms

    b, size = 16, 640
    cuda_stem.LAUNCHES = 0
    for v in csp.LAUNCHES:
        csp.LAUNCHES[v] = 0
    res = probe.run(b, size, dev, iters=20)
    torch.cuda.synchronize()
    launches = dict(csp.LAUNCHES, full=cuda_stem.LAUNCHES)
    check(all(n > 0 for n in launches.values()),
          f"a probe variant was not launched: {launches}")
    for v in ("dblbuf", "pipe"):
        check(res[v]["bit_identical_to_full"],
              f"the probe's entry point: {v} is not bit-identical to full")

    canvas, w, bias = probe.make_inputs(b, size, dev)
    full = cuda_stem.stem_eval(canvas, w, bias)
    b_lib = bias.to(torch.bfloat16)
    library = {"full": lambda: stem_library(canvas, w, bias),
               "conv": lambda: F.conv2d(canvas, w, b_lib, stride=2),
               "pool": None}
    out = {}
    for v in csp.VARIANTS:
        got = csp.stem_probe(v, canvas, w, bias)
        torch.cuda.synchronize()
        ref = csp.PLAIN[v](canvas, w, bias)
        o, r = got.float(), ref.float()
        err = (o - r).abs()
        frac = (o == r).float().mean().item()
        check(bool(torch.isfinite(o).all()), f"probe {v}: output not finite")
        if v == "pool":
            check(torch.equal(got, ref), f"probe pool: {frac:.6f} bit-equal to its "
                  f"plain version (need 1.0)")
        else:
            check(bool(torch.all(err <= 0.03 + 0.02 * r.abs())) and frac >= 0.999,
                  f"probe {v}: {frac:.6f} bit-equal (need 0.999), max err "
                  f"{err.max().item():.4g} (atol 0.03, rtol 0.02)")
        note = ""
        if v == "conv":
            check(bool((torch.relu(o) <= full.float()).all()),
                  "probe conv: relu(conv) <= full does not hold")
            note = ", relu(conv) <= full: True"
        elif v in ("dblbuf", "pipe"):
            check(torch.equal(got, full), f"probe {v} is not bit-identical to full")
            note = ", bit-identical to full: True"
        lib = library.get(v, library["full"])
        bound_ms, bound_by = res[v]["bound_ms"], res[v]["bound_by"]
        out[v] = dict(max_abs_err=err.max().item(), bit_equal=frac, ms=res[v]["ms"],
                      plain_ms=device_ms(lambda: csp.PLAIN[v](canvas, w, bias), 5),
                      library_ms=None if lib is None else device_ms(lib, 20),
                      bound_ms=bound_ms, bound_by=bound_by, launches=launches[v])
        t = out[v]
        lib_s = "null" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        print(f"[probe] {v:6s} b{b} {size}²: launches {launches[v]}, bit-equal to plain "
              f"{frac:.6f}, max_abs_err {t['max_abs_err']:.4g}{note}"
              f" | kernel_ms {t['ms']:.4f} ({t['ms'] / b * 1e3:.2f} us/img) plain_ms "
              f"{t['plain_ms']:.4f} library_ms {lib_s} bound_ms {bound_ms:.5f} "
              f"({bound_by})")
    full_ms = out["full"]["ms"]
    split = (out["conv"]["ms"] + out["pool"]["ms"]) / full_ms
    print(f"[probe] split: conv {out['conv']['ms']:.4f} + pool {out['pool']['ms']:.4f} "
          f"= {split:.3f} of full {full_ms:.4f} ms; pool / full "
          f"{out['pool']['ms'] / full_ms:.3f}, conv / full {out['conv']['ms'] / full_ms:.3f}, "
          f"dblbuf / full {out['dblbuf']['ms'] / full_ms:.3f}, pipe / full "
          f"{out['pipe']['ms'] / full_ms:.3f}")
    # reported, not required: a kernel slower than these stays, with its times
    conv, dbl = out["conv"], out["dblbuf"]
    print(f"[probe] conv below its library call: {conv['ms'] < conv['library_ms']}; "
          f"dblbuf below its library call: {dbl['ms'] < dbl['library_ms']}, within "
          f"1.10x of full: {dbl['ms'] <= 1.10 * full_ms} ({dbl['ms'] / full_ms:.3f})")
    return out


def phase_deploy(dev):
    """The deploy serving graph: YOLOPredictor(deploy, fold_shuffle,
    cast_weights) at b8 640² bf16, with the launch counts read around one
    replay of its b8 batch's CUDA graph; against the train-graph predictor from the same init_model
    weights at the serving limits (per anchor: scores 0.005, boxes 0.5 px,
    classes equal; NMS kernel == plain on the same predictions)."""
    from dcfa_yolo_tpu_torch.infer.pipeline import predict
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
    from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem
    from dcfa_yolo_tpu_torch.ops.nms import batched_nms

    kw = dict(input_shape=(640, 640), phi="n", confidence=0.001, nms_iou=0.5,
              compute_dtype="bfloat16", seed=SEED)
    dep = YOLOPredictor(["object"], deploy=True, fold_shuffle=True, cast_weights=True, **kw)
    base = YOLOPredictor(["object"], **kw)
    rgb8, nir8 = serve_inputs(8, SEED + 50)
    dep.detect_batch(rgb8, nir8)  # captures the b8 graph; the count below is one replay
    cuda_stem.LAUNCHES = cuda_nms.LAUNCHES = 0
    dets = dep.detect_batch(rgb8, nir8)
    torch.cuda.synchronize()
    launches = {"stem_eval": cuda_stem.LAUNCHES, "nms_suppress": cuda_nms.LAUNCHES}
    print(f"[deploy] b8 batch: launches {launches}, detections "
          f"{[len(d[0]) for d in dets]}")
    check(launches == {"stem_eval": 2, "nms_suppress": 1},
          f"expected 2 stem and 1 NMS launches on the deploy path, got {launches}")
    for boxes, scores, _ in dets:
        check(len(boxes) > 0 and np.isfinite(boxes).all() and np.isfinite(scores).all(),
              "deploy path: no or non-finite detections")

    bd, sd, cd = predict(dep.model, rgb8, nir8)
    bb, sb, cb = predict(base.model, rgb8, nir8)
    box_err = ((bd - bb).abs().max() * 640).item()
    score_err = (sd - sb).abs().max().item()
    print(f"[deploy] deploy + folded + cast vs train graph, b8 per-anchor: max "
          f"|Δscore| {score_err:.3g} (tol 0.005), max |Δbox| {box_err:.3g} px (tol 0.5)")
    check(torch.equal(cd, cb) and score_err <= 0.005 and box_err <= 0.5,
          "the deploy graph disagrees with the train graph")
    nms_kw = dict(conf_thres=0.001, iou_thres=0.5, pre_nms_topk=1024, max_det=300)
    rk = batched_nms(bd, sd, cd, backend="kernel", **nms_kw)
    rp = batched_nms(bd, sd, cd, backend="plain", **nms_kw)
    for name in rk._fields:
        check(torch.equal(getattr(rk, name), getattr(rp, name)),
              f"NMS {name} differs between kernel and plain on the deploy predictions")
    print("[deploy] NMS kernel == plain on the deploy b8 predictions")

    def rate(pred):
        pred.detect_batch(rgb8, nir8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            pred.detect_batch(rgb8, nir8)
        torch.cuda.synchronize()
        return 80 / (time.perf_counter() - t0)

    print(f"[deploy] b8 pairs/s (host clock, 10 calls): deploy graph {rate(dep):.1f}, "
          f"train graph {rate(base):.1f}")
    return launches


NMS_FIELDS = ("boxes", "scores", "classes", "valid", "n_candidates")


def equal_results(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in NMS_FIELDS)


def host_ms(fn, calls=20):
    """Host-clock ms a call of `fn()`, each call ending in a synchronise,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def phase_graph(dev):
    """The captured pipeline (`detect_batch_graph`, one CUDA graph a key)
    against the eager `detect_batch` on 480×640 seeded pairs at 640² bf16,
    conf 0.001, IoU 0.5, kernels A and B: for the train graph and for the
    deploy + folded + cast graph, at b1 and b8, `pre_nms_topk` 1024 and
    8400, `letterbox` True and False.  Each replay equals the eager call
    (`torch.equal` on every output field), a second input through the same
    graph equals its eager result while the first result, still held, stays
    unchanged; each key captures once; every replay counts 2 stem and 1
    NMS launches.  Then eager and replay ms a call at b1 and b8."""
    from dcfa_yolo_tpu_torch.infer.pipeline import (detect_batch, detect_batch_graph,
                                                    graph_count, release_graphs)
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
    from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem

    kw = dict(input_shape=(640, 640), phi="n", confidence=0.001, nms_iou=0.5,
              compute_dtype="bfloat16", seed=SEED)
    models = {"train": YOLOPredictor(["object"], **kw).model,
              "deploy": YOLOPredictor(["object"], deploy=True, fold_shuffle=True,
                                      cast_weights=True, **kw).model}
    torch.cuda.reset_peak_memory_stats()
    keys = 0
    for name, model in models.items():
        for b in (1, 8):
            inputs = [serve_inputs(b, SEED + 70 + 10 * b + i) for i in range(2)]
            hw = np.tile([480.0, 640.0], (b, 1)).astype(np.float32)
            for topk in (1024, 8400):
                for letterbox in (True, False):
                    nkw = dict(conf_thres=0.001, iou_thres=0.5, letterbox=letterbox,
                               max_det=300, pre_nms_topk=topk, nms="kernel",
                               stem="kernel")
                    what = f"{name} b{b} topk {topk} letterbox {letterbox}"
                    eager = [detect_batch(model, r, n, hw, **nkw) for r, n in inputs]
                    n0 = graph_count(model)
                    first = detect_batch_graph(model, *inputs[0], hw, **nkw)
                    keys += 1
                    check(graph_count(model) == n0 + 1, f"{what}: no capture")
                    cuda_stem.LAUNCHES = cuda_nms.LAUNCHES = 0
                    again = detect_batch_graph(model, *inputs[0], hw, **nkw)
                    second = detect_batch_graph(model, *inputs[1], hw, **nkw)
                    torch.cuda.synchronize()
                    launches = (cuda_stem.LAUNCHES, cuda_nms.LAUNCHES)
                    check(graph_count(model) == n0 + 1,
                          f"{what}: the key captured more than once")
                    check(launches == (4, 2), f"{what}: two replays counted "
                          f"{launches} stem and NMS launches, expected (4, 2)")
                    for got, want, which in ((first, eager[0], "first replay"),
                                             (again, eager[0], "replay"),
                                             (second, eager[1], "second input"),
                                             (first, eager[0], "held result")):
                        bad = [f for f in NMS_FIELDS
                               if not torch.equal(getattr(got, f), getattr(want, f))]
                        check(not bad, f"{what}: {which} differs from the eager "
                              f"call in {bad}")
                    check(bool(eager[0].valid.any()), f"{what}: no detections")
    print(f"[graph] {keys} keys over the train and deploy graphs (b1, b8; "
          f"pre_nms_topk 1024, 8400; letterbox True, False): every replay "
          f"torch.equal to the eager call on {NMS_FIELDS}, a second input equal to "
          f"its eager result, the held first result unchanged, one capture a key, "
          f"2 stem + 1 NMS launches counted a replay")
    print(f"[graph] peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
          f"MiB with {sum(graph_count(m) for m in models.values())} graphs held | {CARD}")
    times = {}
    for name, model in models.items():
        for b in (1, 8):
            r, n = serve_inputs(b, SEED + 90 + b)
            hw = np.tile([480.0, 640.0], (b, 1)).astype(np.float32)
            nkw = dict(conf_thres=0.001, iou_thres=0.5, max_det=300, pre_nms_topk=1024)
            times[name, b] = (host_ms(lambda: detect_batch(model, r, n, hw, **nkw)),
                              host_ms(lambda: detect_batch_graph(model, r, n, hw, **nkw)))
            eager_ms, replay_ms = times[name, b]
            print(f"[graph] {name} graph b{b}: eager {eager_ms:.3f} ms/call, replay "
                  f"{replay_ms:.3f} ms/call ({eager_ms / replay_ms:.2f}x; host clock, "
                  f"20 calls, each ending in a synchronise, uint8 480x640 host input "
                  f"copied in) | {CARD}")
    for model in models.values():
        release_graphs(model)
    torch.cuda.empty_cache()
    return times


def synth_pairs(n):
    """`n` synthetic 480×360 pairs (the port's `tools/make_synth_dataset.py`)
    as uint8 arrays, and their directory's dataset (kept for [cli])."""
    import tempfile

    from PIL import Image

    from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    make_dataset(tmp, n, (480, 360))
    voc = os.path.join(tmp, "VOCdevkit", "VOC2007")
    ids = sorted(f[:-4] for f in os.listdir(os.path.join(voc, "Annotations")))
    pairs = [tuple(np.asarray(Image.open(os.path.join(voc, sub, i + ".png")))
                   for sub in ("JPEGImages_rgb", "JPEGImages_nir")) for i in ids]
    return tmp, pairs


def trained_variables():
    from dcfa_yolo_tpu_torch.models.convert import load_flat_npz

    here = os.path.dirname(os.path.abspath(__file__))
    return load_flat_npz(os.path.join(here, "tests", "fixtures", "ab_weights_f16.npz"))


class plain_stem_kernel:
    """Within this block the serving pipeline's kernel stem runs kernel A's
    plain version (`stem_eval_plain`) in place of the kernel."""

    def __enter__(self):
        from dcfa_yolo_tpu_torch.infer import pipeline
        from dcfa_yolo_tpu_torch.ops import cuda_stem

        self.kernel = pipeline.stem_eval
        pipeline.stem_eval = cuda_stem.stem_eval_plain

    def __exit__(self, *exc):
        from dcfa_yolo_tpu_torch.infer import pipeline

        pipeline.stem_eval = self.kernel


def per_image_agreement(served, ref):
    """Counts, classes equal, max |Δbox| px and max |Δscore| over the
    pairs, slot by slot; two lists of (boxes, scores, classes)."""
    counts, classes, box, score = [], True, 0.0, 0.0
    for (bs, ss, cs), (rb, rs, rc) in zip(served, ref):
        counts.append((len(bs), len(rb)))
        if len(bs) != len(rb):
            continue
        classes &= bool(np.array_equal(cs, rc))
        if len(bs):
            box = max(box, float(np.abs(bs - rb).max()))
            score = max(score, float(np.abs(ss - rs).max()))
    return counts, classes, box, score


def nearest_slots(served, ref):
    """`ref`'s detections of each image put in the slots of `served`'s
    nearest boxes (greedy, nearest pair first), so that two detections of
    near-equal score that trade places compare with their own
    counterparts.  Images whose counts differ are left as they are."""
    out = []
    for (bs, _, _), (rb, rs, rc) in zip(served, ref):
        if len(bs) != len(rb) or not len(bs):
            out.append((rb, rs, rc))
            continue
        dist = np.abs(bs[:, None] - rb[None]).max(-1)
        order = np.full(len(bs), -1)
        for flat in np.argsort(dist, axis=None):
            i, j = divmod(int(flat), len(rb))
            if order[i] < 0 and j not in order:
                order[i] = j
        out.append((rb[order], rs[order], rc[order]))
    return out


def phase_trained(dev, pairs):
    """Trained weights (`tests/fixtures/ab_weights_f16.npz`, loaded through
    `models/convert.py::unflatten`) on 8 synthetic 480×360 pairs at conf
    0.5, IoU 0.5, image by image: the served graph path against the eager
    path with every kernel replaced by its plain version.
      * float32 (kernel B in the graph; kernel A takes bf16 only) against
        the float32 all-plain path, at the limits
        tests/test_fold_shuffle.py:127-131 puts on this fixture in float32:
        the same number of detections (more than 0 in all), classes equal,
        boxes within 1 px, scores within 1e-3;
      * bf16 (kernels A and B in the graph) against the bf16 path with
        `stem_eval_plain` and the plain NMS: the same counts and classes,
        boxes within 1 px, and scores within the JAX package's bf16
        criterion for its kernel stem against its XLA stem
        (tests/test_pallas_stem.py:298-306), 0.005: bf16 logits step by
        2^-6 near a score of 0.95, which moves the score by 7.4e-4.
    The bf16 graph is also measured, not held, against the bf16 ConvMaxpool
    stem and the float32 path."""
    from dcfa_yolo_tpu_torch.infer.pipeline import detect_batch
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
    from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem

    nkw = dict(conf_thres=0.5, iou_thres=0.5, max_det=100, pre_nms_topk=2048)

    def dets(res):
        """NMSResult of one image → (boxes, scores, classes) on the host."""
        k = int(res.valid[0].sum())
        return tuple(t[0][:k].cpu().numpy() for t in (res.boxes, res.scores, res.classes))

    def eager(model, stem):
        return [dets(detect_batch(model, r[None], n[None],
                                  np.array([r.shape[:2]], np.float32),
                                  nms="plain", stem=stem, **nkw)) for r, n in pairs]

    held = {}
    for dtype, score_tol in (("float32", 1e-3), ("bfloat16", 0.005)):
        pred = YOLOPredictor(["tomato_bunch"], input_shape=(640, 640), phi="n",
                             confidence=0.5, nms_iou=0.5, max_det=100,
                             pre_nms_topk=2048, compute_dtype=dtype,
                             variables=trained_variables())
        cuda_stem.LAUNCHES = cuda_nms.LAUNCHES = 0
        served = [pred.detect(r, n) for r, n in pairs]
        torch.cuda.synchronize()
        launches = (cuda_stem.LAUNCHES, cuda_nms.LAUNCHES)
        # one key, one capture, whose eager warm-up launches once more
        calls = len(pairs) + 1
        want = (2 * calls if dtype == "bfloat16" else 0, calls)
        check(launches == want, f"trained {dtype}: {len(pairs)} served pairs counted "
              f"{launches} stem and NMS launches, expected {want}")
        if dtype == "bfloat16":
            with plain_stem_kernel():
                ref = eager(pred.model, "kernel")
        else:
            ref = eager(pred.model, "plain")
        counts, classes, box, score = per_image_agreement(served, ref)
        held[dtype] = served
        print(f"[trained] {dtype}: served graph (launches {launches}) vs the plain "
              f"versions' eager path: detections {[c for c, _ in counts]} / "
              f"{[k for _, k in counts]}, classes equal {classes}, max |Δbox| "
              f"{box:.4g} px (limit 1), max |Δscore| {score:.4g} (limit {score_tol:g})")
        check(all(c == k for c, k in counts) and sum(k for _, k in counts) > 0,
              f"trained {dtype}: detection counts differ or are all 0: {counts}")
        check(classes and box <= 1.0 and score <= score_tol,
              f"trained {dtype}: classes equal {classes}, max |Δbox| {box:.4g} px "
              f"(limit 1), max |Δscore| {score:.4g} (limit {score_tol:g})")
        if dtype == "bfloat16":
            counts, classes, box, score = per_image_agreement(served, eager(pred.model, "plain"))
            print(f"[trained] bf16 served graph vs the bf16 ConvMaxpool stem and plain "
                  f"NMS (reported): counts equal {all(c == k for c, k in counts)}, "
                  f"classes equal {classes}, max |Δbox| {box:.4g} px, max |Δscore| "
                  f"{score:.4g} (slot by slot)")
        pred.release_graphs()
    counts, classes, box, score = per_image_agreement(held["bfloat16"], held["float32"])
    print(f"[trained] bf16 served graph vs float32 served graph (reported): counts equal "
          f"{all(c == k for c, k in counts)}, classes equal {classes}, max |Δbox| "
          f"{box:.4g} px, max |Δscore| {score:.4g} (slot by slot)")
    return held


def phase_cli(dev, data_dir):
    """The serving CLIs in-process on the card, on [trained]'s 8 synthetic
    pairs with the trained weights as a port checkpoint: `predict` in modes
    predict, fps (--test-interval 20) and dir_predict at --batch-size 1 and
    3; `get_map` in --map-mode 0 with a binding --pre-nms-topk that must
    auto-raise, then --map-mode 4 on its files; `get_map --no-auto-raise`,
    which must fail.  Kernels A and B must launch in each."""
    import shutil

    from dcfa_yolo_tpu_torch import get_map, predict
    from dcfa_yolo_tpu_torch.data import voc
    from dcfa_yolo_tpu_torch.models.convert import from_jax_variables
    from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem
    from dcfa_yolo_tpu_torch.utils.checkpoint import save_checkpoint

    sd = from_jax_variables(trained_variables())
    buffers = ("running_mean", "running_var")
    ckpt = os.path.join(data_dir, "trained.ckpt")
    save_checkpoint(ckpt, dict(
        params={k: v for k, v in sd.items() if not k.endswith(buffers)},
        batch_stats={k: v for k, v in sd.items() if k.endswith(buffers)},
        ema={}, opt_state={}, ema_updates=0, epoch=0))
    devkit = os.path.join(data_dir, "VOCdevkit")
    voc.generate_imagesets(devkit, trainval_percent=0.0)  # every pair in test
    src = os.path.join(devkit, "VOC2007")
    img = os.path.join(data_dir, "img")
    for sub in ("rgb", "nir"):
        shutil.copytree(os.path.join(src, f"JPEGImages_{sub}"), os.path.join(img, sub))
    first = sorted(os.listdir(os.path.join(img, "rgb")))[0]
    model = ["--model-path", ckpt, "--classes-path",
             os.path.join(data_dir, "model_data", "voc_classes.txt"),
             "--input-shape", "640", "640", "--device", str(dev)]
    pair = ["--rgb", os.path.join(img, "rgb", first), "--nir", os.path.join(img, "nir", first)]

    def counted(fn):
        cuda_stem.LAUNCHES = cuda_nms.LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        n = (cuda_stem.LAUNCHES, cuda_nms.LAUNCHES)
        check(n[0] > 0 and n[1] > 0, f"cli: no stem or NMS launch: {n}")
        return out, n, time.perf_counter() - t0

    runs = [("predict", ["--mode", "predict", "--output",
                         os.path.join(data_dir, "out", "p.png")] + pair),
            ("fps", ["--mode", "fps", "--test-interval", "20"] + pair)]
    runs += [(f"dir_predict b{b}", ["--mode", "dir_predict", "--dir-origin-path", img,
                                    "--dir-save-path", os.path.join(data_dir, f"out_b{b}"),
                                    "--batch-size", str(b)]) for b in (1, 3)]
    for what, argv in runs:
        out, n, sec = counted(lambda: predict.run(argv + model))
        extra = (f", {out['seconds'] * 1e3:.3f} ms a call" if "seconds" in out
                 else f", {len(out['names'])} images" if "names" in out else "")
        print(f"[cli] predict {what}: launches {n}{extra}, {sec:.1f} s")
    check(len(os.listdir(os.path.join(data_dir, "out_b3"))) == 8,
          "cli: dir_predict --batch-size 3 did not write 8 images")
    gm = model + ["--vocdevkit-path", devkit, "--map-out-path",
                  os.path.join(data_dir, "map_out"), "--confidence", "0.001"]
    out, n, sec = counted(lambda: get_map.run(["--map-mode", "0", "--pre-nms-topk", "8"] + gm))
    att = out["attempts"]
    check(len(att) >= 2 and att[0]["topk_bound"] > 0 and not att[-1]["topk_bound"],
          f"cli: get_map did not auto-raise a binding --pre-nms-topk 8: {att}")
    print(f"[cli] get_map --map-mode 0 --pre-nms-topk 8: {len(att)} attempts "
          f"(pre_nms_topk {[a['pre_nms_topk'] for a in att]}, max candidates "
          f"{att[0]['max_candidates']}), VOC mAP50 {out['voc_map']:.4f}; launches {n}, "
          f"{sec:.1f} s")
    out4 = get_map.run(["--map-mode", "4"] + gm)
    print(f"[cli] get_map --map-mode 4: AP {out4['coco_ap']:.4f}, AP50 "
          f"{out4['coco_ap50']:.4f}")
    code = None
    try:
        get_map.run(["--map-mode", "1", "--pre-nms-topk", "8", "--no-auto-raise"] + gm)
    except SystemExit as e:
        code = e.code
    check(code not in (None, 0), f"cli: get_map --no-auto-raise did not fail ({code!r})")
    print(f"[cli] get_map --no-auto-raise with a binding cap exits non-zero: {code}")


def phase_interop(dev, pairs, trained):
    """Weights in and out, at phi='n' 640²:
      1. the golden manifest's synthetic weights written as the reference's
         `.pth`, loaded by `YOLOPredictor(model_path=...)` in float32 (TF32
         off): the forward against the reference's own outputs
         (`tests/goldens/model_fwd.npz`) at tests/test_model_parity.py's
         limits (`utils/golden.py::golden_errors`);
      2. the same `.pth` served in bf16 through the captured graph at b1 and
         b8, conf 0.001: kernels A and B launched 2 and 1 times a replay;
         per-anchor predictions against kernel A's plain version at
         [serve]'s limits (scores 0.005, boxes 0.5 px, classes equal), NMS
         kernel == plain on the same predictions;
      3. the trained fixture exported to the reference's `.npz` and loaded
         back: the state_dict bit-equal, the served detections of
         [trained]'s 8 pairs `torch.equal` to [trained]'s in float32 and bf16;
      4. the deploy pipeline with those weights exported by
         `python -m dcfa_yolo_tpu_torch.tools.export` (in-process; its own
         round trip holds the loaded artifact equal to the in-process plain
         pipeline), then run on the card on 8 synthetic 640² pairs against
         the in-process plain pipeline at rtol 1e-5, atol 1e-4
         (tests/test_export_stablehlo.py:56-57); export seconds, bytes, and
         ms a call of the artifact beside the captured graph's.
    Returns the launches of step 2."""
    import tempfile

    from PIL import Image

    from dcfa_yolo_tpu_torch.config import ModelConfig
    from dcfa_yolo_tpu_torch.infer.pipeline import (detect_batch_graph, predict,
                                                    release_graphs)
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
    from dcfa_yolo_tpu_torch.models.convert import from_jax_variables
    from dcfa_yolo_tpu_torch.models.torch_export import save_torch_npz
    from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo
    from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem
    from dcfa_yolo_tpu_torch.ops.nms import batched_nms
    from dcfa_yolo_tpu_torch.tools import export
    from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset
    from dcfa_yolo_tpu_torch.utils import golden
    from dcfa_yolo_tpu_torch.utils.checkpoint import load_variables

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_interop_")
    try:
        # 1. the reference's .pth against the reference's outputs, float32
        manifest = golden.load_manifest(os.path.join(here, "tests", "goldens",
                                                     "manifest.json"))
        pth = os.path.join(tmp, "reference.pth")
        torch.save({k: torch.from_numpy(v)
                    for k, v in golden.synth_state_dict(manifest, SEED).items()}, pth)
        with np.load(os.path.join(here, "tests", "goldens", "model_fwd.npz")) as z:
            goldens = {k: z[k] for k in z.files}
        pred = YOLOPredictor(["object"], input_shape=(640, 640), model_path=pth,
                             compute_dtype="float32", device=dev)
        errors = golden.golden_errors(pred.model, goldens)
        worst = max(errors, key=errors.get)
        print(f"[interop] reference .pth ({len(manifest)} keys) through YOLOPredictor, "
              f"float32, TF32 off, against model_fwd.npz: {len(errors)} outputs, worst "
              f"{worst} at {errors[worst]:.4g} of its limit (test_model_parity.py's "
              f"rtol/atol; 1 = at the limit)")
        check(all(v <= 1.0 for v in errors.values()),
              f"the reference .pth misses the golden limits: {errors}")
        del pred

        # 2. the same weights served in bf16 through the captured graph
        kw = dict(input_shape=(640, 640), phi="n", confidence=0.001, nms_iou=0.5,
                  compute_dtype="bfloat16", model_path=pth, device=dev)
        pred = YOLOPredictor(["object"], **kw)
        r1, n1 = serve_inputs(1, SEED + 110)
        rgb8, nir8 = serve_inputs(8, SEED + 111)
        pred.detect(r1[0], n1[0])
        pred.detect_batch(rgb8, nir8)  # both keys captured: the count is replays only
        cuda_stem.LAUNCHES = cuda_nms.LAUNCHES = 0
        dets = [pred.detect(r1[0], n1[0])] + pred.detect_batch(rgb8, nir8)
        torch.cuda.synchronize()
        launches = {"stem_eval": cuda_stem.LAUNCHES, "nms_suppress": cuda_nms.LAUNCHES}
        check(launches == {"stem_eval": 4, "nms_suppress": 2},
              f"reference .pth served at b1 and b8: expected 2 stem and 1 NMS launches "
              f"a replay, got {launches} over two replays")
        for boxes, scores, _ in dets:
            check(len(boxes) > 0 and np.isfinite(boxes).all() and np.isfinite(scores).all(),
                  "reference .pth served: no or non-finite detections")
        bk, sk, ck = predict(pred.model, rgb8, nir8, stem="kernel")
        with plain_stem_kernel():
            bp, sp, cp = predict(pred.model, rgb8, nir8, stem="kernel")
        box_err = ((bk - bp).abs().max() * 640).item()
        score_err = (sk - sp).abs().max().item()
        nms_kw = dict(conf_thres=0.001, iou_thres=0.5, pre_nms_topk=1024, max_det=300)
        rk = batched_nms(bk, sk, ck, backend="kernel", **nms_kw)
        rp = batched_nms(bk, sk, ck, backend="plain", **nms_kw)
        nms_equal = equal_results(rk, rp)
        print(f"[interop] reference .pth served bf16 through the graph, b1 + b8: launches "
              f"{launches}, detections {[len(d[0]) for d in dets]}; b8 per-anchor against "
              f"kernel A's plain version: max |Δscore| {score_err:.3g} (tol 0.005), max "
              f"|Δbox| {box_err:.3g} px (tol 0.5), classes equal {torch.equal(ck, cp)}; "
              f"NMS kernel == plain {nms_equal}")
        check(torch.equal(ck, cp) and score_err <= 0.005 and box_err <= 0.5 and nms_equal,
              "the served reference .pth disagrees with the plain versions")
        pred.release_graphs()
        del pred

        # 3. the trained fixture out to the reference's .npz and back in
        sd = from_jax_variables(trained_variables())
        npz = os.path.join(tmp, "trained.npz")
        save_torch_npz(npz, sd, num_classes=1)
        back = load_variables(npz, lambda: DCFAYolo(ModelConfig(num_classes=1,
                                                                phi="n")).state_dict())
        check(back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd),
              "the trained weights changed on the way out to the reference's .npz and back")
        for dtype in ("float32", "bfloat16"):
            pred = YOLOPredictor(["tomato_bunch"], input_shape=(640, 640), phi="n",
                                 confidence=0.5, nms_iou=0.5, max_det=100,
                                 pre_nms_topk=2048, compute_dtype=dtype, model_path=npz,
                                 device=dev)
            served = [pred.detect(r, n) for r, n in pairs]
            same = all(all(np.array_equal(a, b) for a, b in zip(x, y))
                       for x, y in zip(served, trained[dtype]))
            print(f"[interop] trained fixture → reference .npz ({os.path.getsize(npz)} "
                  f"bytes) → YOLOPredictor {dtype}: state_dict bit-equal, detections "
                  f"{[len(d[0]) for d in served]} equal to [trained]'s: {same}")
            check(same, f"the reimported .npz serves other detections than [trained] "
                        f"in {dtype}")
            pred.release_graphs()
            del pred

        # 4. the deploy pipeline as a torch.export artifact
        classes = os.path.join(tmp, "classes.txt")
        with open(classes, "w") as f:
            f.write("tomato_bunch\n")
        art = os.path.join(tmp, "pipeline.pt2")
        out = export.run([art, "--model-path", npz, "--classes-path", classes,
                          "--batch", "8", "--size", "640", "--device", str(dev)])
        program = torch.export.load(art).module()
        make_dataset(os.path.join(tmp, "sq"), 8, (640, 640))
        sq = os.path.join(tmp, "sq", "VOCdevkit", "VOC2007")
        ids = sorted(f[:-4] for f in os.listdir(os.path.join(sq, "Annotations")))
        rgb, nir = (torch.from_numpy(np.stack([
            np.asarray(Image.open(os.path.join(sq, sub, i + ".png"))) for i in ids])).to(dev)
            for sub in ("JPEGImages_rgb", "JPEGImages_nir"))
        hw = torch.full((8, 2), 640.0, device=dev)
        with torch.inference_mode():
            got = program(rgb, nir, hw)
            want = out["pipeline"](rgb, nir, hw)
        bad = []
        for name in want:
            a, b = got[name], want[name]
            ok = (torch.allclose(a, b, rtol=1e-5, atol=1e-4) if a.is_floating_point()
                  else torch.equal(a, b))
            if not ok:
                bad.append(name)
        n_det = int(want["valid"].sum())
        check(not bad and n_det > 0, f"the exported artifact differs from the in-process "
              f"plain pipeline in {bad} ({n_det} detections)")
        model = out["pipeline"].model
        graph_kw = dict(conf_thres=0.5, iou_thres=0.3, max_det=300, pre_nms_topk=1024)
        art_ms = host_ms(lambda: program(rgb, nir, hw))
        graph_ms = host_ms(lambda: detect_batch_graph(model, rgb, nir, hw, **graph_kw))
        plain_ms = host_ms(lambda: out["pipeline"](rgb, nir, hw))
        print(f"[interop] torch.export of the deploy pipeline (b8 640², bf16, plain stem "
              f"and NMS): export {out['export_seconds']:.1f} s, {out['bytes']} bytes; "
              f"loaded artifact vs in-process plain pipeline on 8 synthetic pairs "
              f"({n_det} detections): within rtol 1e-5 / atol 1e-4 in every field")
        print(f"[interop] b8 ms a call (host clock, 20 calls, each ending in a "
              f"synchronise): artifact {art_ms:.3f}, in-process plain pipeline "
              f"{plain_ms:.3f}, captured graph with kernels A and B {graph_ms:.3f} "
              f"| {CARD}")
        release_graphs(model)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def per_anchor_gap(a, b, in_hw):
    """(classes equal, max |Δscore|, max |Δbox| px) between two `predict`
    results (normalized xyxy boxes, scores, classes) at input shape in_hw."""
    scale = torch.tensor([in_hw[1], in_hw[0]] * 2, dtype=torch.float32, device=a[0].device)
    return (bool(torch.equal(a[2], b[2])), (a[1] - b[1]).abs().max().item(),
            ((a[0] - b[0]).abs() * scale).max().item())


def graph_holds(model, inputs, nkw, what):
    """`detect_batch_graph` against the eager `detect_batch` for each
    (rgb, nir, image_hw) of `inputs` (same shapes: one key): the first
    call captures, then one replay a input, each `torch.equal` to its eager
    call on every field, with the launch counts set to 0 just before the
    replays and read just after.  Returns ((stem, NMS) launches over the
    replays, the eager results)."""
    from dcfa_yolo_tpu_torch.infer.pipeline import detect_batch, detect_batch_graph
    from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem

    eager = [detect_batch(model, *x, **nkw) for x in inputs]
    detect_batch_graph(model, *inputs[0], **nkw)
    cuda_stem.LAUNCHES = cuda_nms.LAUNCHES = 0
    replays = [detect_batch_graph(model, *x, **nkw) for x in inputs]
    torch.cuda.synchronize()
    launches = (cuda_stem.LAUNCHES, cuda_nms.LAUNCHES)
    for i, (got, want) in enumerate(zip(replays, eager)):
        bad = [f for f in NMS_FIELDS if not torch.equal(getattr(got, f), getattr(want, f))]
        check(not bad, f"{what}: replay {i} differs from the eager call in {bad}")
    return launches, eager


def phase_variants(dev, pairs):
    """[pair] and [split]: the opt-in serving graphs of `YOLOPredictor` on
    the trained fixture (`tests/fixtures/ab_weights_f16.npz`) and [trained]'s
    8 synthetic 480×360 pairs at phi='n' 640², conf 0.5, IoU 0.5,
    `max_det` 100, K 2048, each against the graph it stands in for, on the
    same weights:
      * [pair] fold_shuffle + pair_backbones against fold_shuffle;
      * [split] fold_shuffle + split_neck_concats against fold_shuffle, and
        deploy + fold_shuffle + split_neck_concats (conv kernels pre-cast)
        against deploy + fold_shuffle (pre-cast).
    Each variant is held
      1. through its graph, image by image, in float32 and in bf16, each
         detection against the base graph's of the nearest box
         (`nearest_slots`: two of near-equal score may trade slots): the
         same number of detections (more than 0 in all) and classes, boxes
         within 1 px, scores within 1e-3 in float32
         (tests/test_pair_backbones.py:198-202,
         tests/test_split_concats.py:139-143) and within [trained]'s 0.005
         in bf16;
      2. in bf16 per anchor on the b8 stack, reported: the gap to the
         base graph, and each graph's gap to the float32 base graph.  Both
         variants round in another order than their base (the paired CBAMs
         average per-block means, each rounded to bf16; the split convs sum
         float32 partials of the bf16 operands, cuDNN's bf16 concat conv
         rounds as it does), and the card puts their per-anchor gaps past
         [serve]'s limits (0.005, 0.5 px).  So the stages are held one by
         one: for [pair] kernel A's two stem maps from the block-diagonal
         stem's slices `torch.equal` to the unpaired model's; for [split]
         the parts conv at the P3 fusion (`conv3_for_upsample2.cv1`, b8,
         80², N(0, 1) bf16 parts) within one bf16 step of the exact conv of
         its bf16 operands rounded once, and equal to it in at least 99%
         of the outputs (cuDNN's concat conv beside it, reported); for both
         kernel B `torch.equal` to its plain version on the variant's
         predictions;
      3. in bf16 through the captured graph at b1 and b8: one replay each
         `torch.equal` to the eager call, kernels A and B launched 2 and 1
         times a replay;
    then its bf16 replay ms a call at b1 and b8 beside its base graph's
    (host clock, 20 calls each ending in a synchronise; uint8 480×360 host
    input copied in), and for [pair] also the deploy + fold + pair graph's.
    Returns the launches of step 3 over all variants."""
    from dcfa_yolo_tpu_torch.infer.pipeline import (_kernel_stem_outs, detect_batch_graph,
                                                    predict, release_graphs)
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
    from dcfa_yolo_tpu_torch.models.convert import from_jax_variables
    from dcfa_yolo_tpu_torch.models.reparam import serving_state_dict
    from dcfa_yolo_tpu_torch.ops.nms import batched_nms

    sd = from_jax_variables(trained_variables())
    nkw = dict(conf_thres=0.5, iou_thres=0.5, max_det=100, pre_nms_topk=2048)
    rgb8 = np.stack([r for r, _ in pairs])
    nir8 = np.stack([n for _, n in pairs])
    hw8 = np.tile(np.asarray(rgb8.shape[1:3], np.float32), (len(rgb8), 1))
    b1 = (rgb8[:1], nir8[:1], hw8[:1])
    b8 = (rgb8, nir8, hw8)

    def make(dtype, deploy=False, fold_shuffle=True, pair_backbones=False,
             split_neck_concats=False):
        return YOLOPredictor(
            ["tomato_bunch"], input_shape=(640, 640), phi="n", confidence=0.5,
            nms_iou=0.5, max_det=100, pre_nms_topk=2048, compute_dtype=dtype,
            state_dict=serving_state_dict(sd, deploy, fold_shuffle, pair_backbones),
            deploy=deploy, fold_shuffle=fold_shuffle, pair_backbones=pair_backbones,
            split_neck_concats=split_neck_concats, cast_weights=deploy, device=dev)

    def replay_ms(model):
        return {b: host_ms(lambda x=x: detect_batch_graph(model, *x, **nkw))
                for b, x in ((1, b1), (8, b8))}

    runs = (("pair", "fold + pair", dict(pair_backbones=True), {}),
            ("split", "fold + split", dict(split_neck_concats=True), {}),
            ("split", "deploy + fold + split", dict(deploy=True, split_neck_concats=True),
             dict(deploy=True)))
    total = {"stem_eval": 0, "nms_suppress": 0}
    for phase, name, graph, base_graph in runs:
        tag = f"[{phase}] {name}"
        base_name = "deploy + fold" if base_graph else "fold"
        # 1. the trained-weights detections image by image, float32 and bf16
        for dtype, score_tol in (("float32", 1e-3), ("bfloat16", 0.005)):
            preds = [make(dtype, **g) for g in (graph, base_graph)]
            served = [[p.detect(r, n) for r, n in pairs] for p in preds]
            counts, classes, box, score = per_image_agreement(
                served[0], nearest_slots(*served))
            print(f"{tag} vs {base_name}, {dtype} through the graph, detections "
                  f"matched by nearest box: "
                  f"{[c for c, _ in counts]} / {[k for _, k in counts]}, classes equal "
                  f"{classes}, max |Δbox| {box:.4g} px (limit 1), max |Δscore| "
                  f"{score:.4g} (limit {score_tol:g})")
            check(all(c == k for c, k in counts) and sum(k for _, k in counts) > 0
                  and classes and box <= 1.0 and score <= score_tol,
                  f"{tag}: {dtype} detections disagree with the {base_name} graph's")
            for p in preds:
                p.release_graphs()
            if dtype == "float32":
                f32_base = preds[1].model
        var, base = (p.model for p in preds)
        # 2. bf16 per anchor on the b8 stack, reported; the stages held
        pv, pb, pf = (predict(m, rgb8, nir8) for m in (var, base, f32_base))
        gaps = [per_anchor_gap(a, b, (640, 640)) for a, b in ((pv, pb), (pv, pf), (pb, pf))]
        print(f"{tag}, bf16 b8 per anchor (reported): vs {base_name} bf16 classes equal "
              f"{gaps[0][0]}, max |Δscore| {gaps[0][1]:.4g}, max |Δbox| {gaps[0][2]:.4g} "
              f"px; vs {base_name} float32 {gaps[1][1]:.4g} / {gaps[1][2]:.4g} px, where "
              f"{base_name} bf16 is {gaps[2][1]:.4g} / {gaps[2][2]:.4g} px from it")
        del f32_base
        if phase == "pair":
            stems = [_kernel_stem_outs(m, torch.as_tensor(rgb8, device=dev),
                                       torch.as_tensor(nir8, device=dev))
                     for m in (var, base)]
            same = all(torch.equal(a, b) for a, b in zip(*stems))
            print(f"{tag}: kernel A's stem maps from the block-diagonal stem's slices "
                  f"torch.equal to the unpaired model's: {same}")
            check(same, f"{tag}: the paired stem maps differ from the unpaired ones")
        else:
            split_conv_stage(var.conv3_for_upsample2.cv1.conv, tag)
        rk, rp = (batched_nms(*pv, backend=be, **nkw) for be in ("kernel", "plain"))
        nms_equal = equal_results(rk, rp)
        print(f"{tag}: kernel B torch.equal to its plain version on the b8 "
              f"predictions: {nms_equal}")
        check(nms_equal, f"{tag}: kernel B differs from its plain version")
        # 3. bf16 through the graph, replays equal to eager, launches counted
        for b, x in ((1, b1), (8, b8)):
            (na, nb), _ = graph_holds(var, [x], dict(nkw, nms="kernel", stem="kernel"),
                                      f"{tag} b{b}")
            check((na, nb) == (2, 1), f"{tag} b{b}: one replay counted {na} stem and "
                  f"{nb} NMS launches, expected 2 and 1")
            total["stem_eval"] += na
            total["nms_suppress"] += nb
        ms = {k: replay_ms(m) for k, m in (("variant", var), ("base", base))}
        print(f"{tag}: bf16 replays torch.equal to eager at b1 and b8, 2 stem + 1 NMS "
              f"launches a replay; replay ms a call b1 {ms['variant'][1]:.3f} / b8 "
              f"{ms['variant'][8]:.3f} against the {base_name} graph's b1 "
              f"{ms['base'][1]:.3f} / b8 {ms['base'][8]:.3f} (host clock, 20 calls each "
              f"ending in a synchronise) | {CARD}")
        for m in (var, base):
            release_graphs(m)
        if phase == "pair":
            dep = make("bfloat16", deploy=True, pair_backbones=True).model
            ms = replay_ms(dep)
            print(f"[pair] deploy + fold + pair (pre-cast), bf16: replay ms a call b1 "
                  f"{ms[1]:.3f} / b8 {ms[8]:.3f} | {CARD}")
            release_graphs(dep)
    torch.cuda.empty_cache()
    return total


def bf16_step(rounded, abs_sum):
    """One bf16 step of each output of a sum rounded to bf16: 2^-7 of its
    magnitude, and where the terms cancel, of 2^-8 of the sum of their
    magnitudes (`abs_sum`): a float32 sum errs by far less than that, a
    sum of bf16-rounded partials by about as much."""
    return 2.0 ** -7 * torch.maximum(rounded.abs(), 2.0 ** -8 * abs_sum)


def split_conv_stage(conv, tag):
    """The split graph's changed stage: `parts_conv` on bf16 parts of the
    neck's widths (the P3 fusion's [p4_up | feat1_rgb | feat1_nir] at b8,
    80², N(0, 1)) against the exact conv of the bf16 operands (float64)
    rounded once to bf16: within one bf16 step everywhere and equal in at
    least 99% of the outputs.  cuDNN's bf16 conv of the concat is measured
    beside it against the same reference, reported."""
    from dcfa_yolo_tpu_torch.ops.conv import parts_conv

    g = torch.Generator(device=conv.weight.device).manual_seed(SEED + 150)
    half = (conv.in_channels - conv.in_channels // 2) // 2
    widths = (conv.in_channels // 2, half, conv.in_channels - conv.in_channels // 2 - half)
    parts = [torch.randn((8, c, 80, 80), generator=g, device=conv.weight.device)
             .to(torch.bfloat16) for c in widths]
    w = conv.weight.to(torch.bfloat16)
    x = torch.cat(parts, 1)
    rounded = torch.nn.functional.conv2d(x.double(), w.double()).to(torch.bfloat16).double()
    step = bf16_step(rounded, torch.nn.functional.conv2d(x.double().abs(), w.double().abs()))

    def stats(y):
        d = (y.double() - rounded).abs()
        return float((d == 0).double().mean()), float((d / step).max())

    with torch.inference_mode():
        split = stats(parts_conv(conv, parts))
        concat = stats(conv(x))
    print(f"{tag}: parts conv at the P3 fusion ({'+'.join(map(str, widths))} -> "
          f"{conv.out_channels} channels, b8 80²) against the exact conv rounded once: "
          f"{split[0]:.6f} equal, at most {split[1]:.3g} bf16 steps (limits 0.99, 1); "
          f"cuDNN's bf16 concat conv: {concat[0]:.6f} equal, at most {concat[1]:.3g} steps "
          f"(reported)")
    check(split[0] >= 0.99 and split[1] <= 1.0,
          f"{tag}: the parts conv does not round once: {split}")


def phase_scales(dev):
    """[scales]: phi='n' bf16, seeded weights, b1 seeded 480×640 uint8
    pairs, conf 0.001, at input shapes 320², 1280² and 320×416: the anchor
    count Σ (h/s)·(w/s) of the per-anchor predictions; kernel A in the
    pipeline against A's plain version per anchor at [serve]'s limits
    (scores 0.005, boxes 0.5 px, classes equal); through the captured graph
    two inputs, each replay `torch.equal` to its eager call, kernels A and
    B launched 2 and 1 times a replay; replay ms a call."""
    from dcfa_yolo_tpu_torch.infer.pipeline import (detect_batch_graph, predict,
                                                    release_graphs)
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor

    total = {"stem_eval": 0, "nms_suppress": 0}
    nkw = dict(conf_thres=0.001, iou_thres=0.5, max_det=300, pre_nms_topk=1024,
               nms="kernel", stem="kernel")
    for in_hw in ((320, 320), (1280, 1280), (320, 416)):
        model = YOLOPredictor(["object"], input_shape=in_hw, phi="n",
                              compute_dtype="bfloat16", seed=SEED, device=dev).model
        r, n = serve_inputs(1, SEED + 130)
        anchors = sum((in_hw[0] // s) * (in_hw[1] // s) for s in (8, 16, 32))
        kern = predict(model, r, n, stem="kernel")
        with plain_stem_kernel():
            plain = predict(model, r, n, stem="kernel")
        eq, ds, db = per_anchor_gap(kern, plain, in_hw)
        check(kern[0].shape == (1, anchors, 4), f"[scales] {in_hw}: {tuple(kern[0].shape)} "
              f"predictions, expected {anchors} anchors")
        inputs = [(*serve_inputs(1, SEED + 131 + i), np.array([[480.0, 640.0]], np.float32))
                  for i in range(2)]
        (na, nb), eager = graph_holds(model, inputs, nkw, f"[scales] {in_hw}")
        ms = host_ms(lambda: detect_batch_graph(model, *inputs[0], **nkw))
        print(f"[scales] {in_hw[0]}x{in_hw[1]}: {anchors} anchors; kernel A vs its plain "
              f"version per anchor: classes equal {eq}, max |Δscore| {ds:.4g} (limit 0.005), "
              f"max |Δbox| {db:.4g} px (limit 0.5); 2 replays torch.equal to eager, "
              f"launches {na} stem + {nb} NMS; detections {int(eager[0].valid.sum())}; "
              f"replay {ms:.3f} ms a call | {CARD}")
        check(eq and ds <= 0.005 and db <= 0.5,
              f"[scales] {in_hw}: kernel A disagrees with its plain version")
        check((na, nb) == (4, 2), f"[scales] {in_hw}: two replays counted {na} stem and "
              f"{nb} NMS launches, expected 4 and 2")
        check(bool(eager[0].valid.any()), f"[scales] {in_hw}: no detections")
        total["stem_eval"] += na
        total["nms_suppress"] += nb
        release_graphs(model)
        del model
    torch.cuda.empty_cache()
    return total


def phase_phis(dev):
    """[phis]: phi s, m, l and x at 640², bf16, seeded weights, b1 seeded
    480×640 pairs, conf 0.001, the 'auto' backends: the stem resolves to the
    plain graph (kernel A is specialised to phi='n''s 16 stem channels), so
    kernel B is the only kernel, launched once a replay; two replays each
    `torch.equal` to the eager call; replay ms a call and peak device
    memory for each phi, with phi='n' (kernels A and B) first as the
    yardstick."""
    from dcfa_yolo_tpu_torch.infer.pipeline import (detect_batch_graph, release_graphs,
                                                    resolve_stem)
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
    from dcfa_yolo_tpu_torch.models.yolo import count_params

    total = {"stem_eval": 0, "nms_suppress": 0}
    nkw = dict(conf_thres=0.001, iou_thres=0.5, max_det=300, pre_nms_topk=1024)
    inputs = [(*serve_inputs(1, SEED + 140 + i), np.array([[480.0, 640.0]], np.float32))
              for i in range(2)]
    for phi in "nsmlx":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**20
        model = YOLOPredictor(["object"], input_shape=(640, 640), phi=phi,
                              compute_dtype="bfloat16", seed=SEED, device=dev).model
        stem = resolve_stem("auto", model.cfg, dev)
        want = ("kernel", 4) if phi == "n" else ("plain", 0)
        check(stem == want[0], f"[phis] phi={phi}: 'auto' resolved the stem to {stem}")
        (na, nb), eager = graph_holds(model, inputs, nkw, f"[phis] {phi}")
        ms = host_ms(lambda: detect_batch_graph(model, *inputs[0], **nkw))
        peak = torch.cuda.max_memory_allocated() / 2**20
        print(f"[phis] phi={phi}: {count_params(model):,} parameters, stem 'auto' -> "
              f"{stem}; 2 replays torch.equal to eager, launches {na} stem + {nb} NMS; "
              f"detections {int(eager[0].valid.sum())}; replay {ms:.3f} ms a call; peak "
              f"device memory {peak:.1f} MiB, {peak - held:.1f} over the {held:.1f} "
              f"held before the model was built | {CARD}")
        check((na, nb) == (want[1], 2), f"[phis] phi={phi}: two replays counted {na} "
              f"stem and {nb} NMS launches, expected {want[1]} and 2")
        total["stem_eval"] += na
        total["nms_suppress"] += nb
        release_graphs(model)
        del model
    torch.cuda.empty_cache()
    return total


def grad_leaves(flat, named):
    """A flat gradient (the trainer's parameter order) as float64 leaves."""
    out, o = {}, 0
    for name, p in named:
        out[name] = flat[o:o + p.numel()].astype(np.float64)
        o += p.numel()
    return out


ABS_FLOOR = 1e-6  # of the gradient's largest entry: float32 rounding of the step


def leaf_cosines(got, ref):
    """Per-leaf (cosine, max |Δ|, max |ref|) of two gradients, the last two
    relative to the reference gradient's largest entry."""
    top = max(np.abs(v).max() for v in ref.values())
    out = {}
    for n, r in ref.items():
        g = got[n]
        den = np.linalg.norm(g) * np.linalg.norm(r)
        out[n] = (float(g @ r / den) if den > 0 else float("nan"),
                  float(np.abs(g - r).max() / top), float(np.abs(r).max() / top))
    return out


def zero_leaves(leaves, cos_tol):
    """The leaves under the cosine limit whose gradient is zero in exact
    arithmetic, where a cosine means nothing: the reference and the
    difference both within ABS_FLOOR of the gradient's largest entry
    (exactly zero: a ReLU dead on the whole batch, a head branch with no
    foreground anchor; rounding residue: a bias that reaches a train-mode
    BN through linear layers only, as the ShuffleNet units' `b2_dwconv.bias`
    and `b2_bn2.bias`).  Every other leaf is held to the cosine limit."""
    return sorted(k for k, (c, d, r) in leaves.items()
                  if not c >= cos_tol and r <= ABS_FLOOR and d <= ABS_FLOOR)


def one_step_grad(trainer, batch):
    """A trainer's loss and flat gradient (float64, on the host) of one
    forward, loss and backward, with no update."""
    lb = trainer.loss(trainer.forward(batch), batch)
    grads = trainer.backward(lb.total)
    return (float(lb.total.detach()),
            torch.cat([g.flatten() for g in grads]).double().cpu().numpy())


class GemmRecorder:
    """While active, counts the matrix products (cuBLAS: mm, addmm, bmm,
    baddbmm) that take a bf16 CUDA operand, by op and operand shapes,
    through a `TorchDispatchMode` (the autograd engine's threads inherit
    it)."""

    GEMMS = ("mm", "addmm", "bmm", "baddbmm", "addbmm", "_scaled_mm")

    def __enter__(self):
        import collections

        from torch.utils._python_dispatch import TorchDispatchMode

        self.counts = counts = collections.Counter()
        gemms = self.GEMMS

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                tensors = [a for a in args if isinstance(a, torch.Tensor)]
                if (func.overloadpacket.__name__ in gemms
                        and any(t.is_cuda and t.dtype == torch.bfloat16 for t in tensors)):
                    counts[func.overloadpacket.__name__ + " " + " @ ".join(
                        "x".join(map(str, t.shape)) for t in tensors)] += 1
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


class StemConvTap(dict):
    """While active, records for each stem of a plain-graph model in a train
    step the conv's input and the cotangent of its output, both in the
    compute dtype: {modality: (x, g)}."""

    def __init__(self, model):
        super().__init__()
        self.convs = {m: getattr(model, f"backbone_{m}").stem.conv for m in ("rgb", "nir")}

    def __enter__(self):
        def hook(m):
            def seen(conv, args, y):
                y.register_hook(lambda g: self.__setitem__(m, (args[0].detach(), g.detach())))
            return seen
        self.handles = [conv.register_forward_hook(hook(m)) for m, conv in self.convs.items()]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def bf16_step_of(t):
    """The bf16 spacing at a tensor's largest magnitude."""
    return 2.0 ** (math.floor(math.log2(float(t.abs().max()))) - 7)


def stem_wgrad_check(x, g, step_grad, modality):
    """The stem conv's weight gradient that the bf16 step took (cuDNN's bf16
    backward; `step_grad`, a leaf of `grad_leaves`) against the JAX
    contract's reduction of the same bf16 operands, the conv's input x and
    its output's cotangent g as the step saw them: summed in float32 (TF32
    is off) and rounded once to bf16.  Within 2 bf16 steps of the largest
    entry."""
    from torch.nn.grad import conv2d_weight

    shape = (16, 3, 3, 3)
    ref = conv2d_weight(x.float(), shape, g.float(), padding=1).to(torch.bfloat16).double()
    step = torch.from_numpy(step_grad).to(ref.device).view(shape)
    d = float((step - ref).abs().max()) / bf16_step_of(ref)
    cos = float((step * ref).sum() / (step.norm() * ref.norm()))
    print(f"[train] {modality} stem conv weight gradient, bf16 step (cuDNN's bf16 backward) "
          f"against the float32 sums of its bf16 operands rounded once: cosine {cos:.7f}, "
          f"max |Δ| {d:.2f} bf16 steps of the largest entry (tol 2) | {CARD}")
    check(d <= 2.0, f"[train] {modality} stem weight gradient off the float32 reduction "
          f"rounded once by {d:.2f} bf16 steps")


def rel_err(got, ref):
    """max |got − ref| relative to |ref|, floored at 1e-3 of max |ref| (a
    channel whose mean sits near zero is held to the others' scale)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3 * np.abs(ref).max())).max())


def stem_moments(after, before, n):
    """The stem BNs' batch mean and biased var recovered from one update of
    their running statistics (momentum 0.1, Bessel n/(n−1))."""
    out = {}
    for mod in ("rgb", "nir"):
        k = f"backbone_{mod}.stem.bn.running_"
        mean = (after[k + "mean"] - 0.9 * before[k + "mean"]) / 0.1
        var = (after[k + "var"] - 0.9 * before[k + "var"]) / 0.1 * (n - 1) / n
        out[mod] = (mean.astype(np.float64), var.astype(np.float64))
    return out


def phase_dp(dev, model):
    """Data-parallel training and serving on this one card: 2 ranks spawned
    (`parallel/mesh.py::run_ranks`, gloo, both on cuda:0, TF32 off), each
    loading the kernel library `phase_build` built, then an NCCL world of 1
    in this process.  Two ranks on one card measure no scaling.
      * kernel C across the ranks: `fused_train_stem` with the group on each
        rank's b4 half of a b8 640² float32 batch against one call on the
        b8 batch (y within 1e-4 of max|y|, moments rtol 1e-4, gradients
        within 1e-4 of their largest; x's per half, the parameters' summed);
        each rank's all-reduced sums against `stem_train_plain` with the
        group and against one b8 launch, at C's sum limit (1e-4 relative);
      * fused, 2 ranks, global b8 (4 a rank) at phi='n' 640², kernel C in
        both stems, the reference init: against this process's one step on
        the b8 batch from the same weights.  float32: loss within 1e-4
        relative, every gradient leaf's cosine ≥ 0.999 but those under it
        that are zero in exact arithmetic (`zero_leaves`, listed), the stems'
        batch moments at C's sum limit (1e-4 relative).  bf16: loss within
        2% ([train]'s limit) and the stems' moments at C's bf16 sum limit
        (1e-3); the leaves' cosines reported, the stem conv's beside
        each bf16 gradient's cosine to the float32 one at b8 and at b4 (the
        one-process b4 step in bf16 and in float32), which says how far
        bf16 alone moves it.  The replicas' states are equal bit for bit
        after every step;
      * split, 2 ranks, the same b4 on both: against one step on that b4,
        at the float32 limits;
      * NCCL, world 1: the fused step through the group `torch.equal` to the
        trainer without one (parameters, BN statistics, EMA) after 2 steps;
      * serving: each rank serves its b4 half of a seeded b8 through
        `detect_batch_graph` (a capture, then a replay: kernels A twice and
        B once), `torch.equal` to this process's b4 call on the same half;
        the gap to the b8 call reported;
    then the ms of a DP step beside the one-process step, the all-reduce of
    the flat gradient (2,678,850 float32) and of C's 256-byte float64 sums
    on gloo and NCCL, kernels A, B and C at the local batch b4 held against
    their plain versions ([stem]'s and [train_stem_f32]'s limits) and timed
    beside their bounds and library calls (A: [stem]'s cuDNN bf16 conv + max
    pool + ReLU; C: [train_stem_f32]'s cuDNN float32 conv, both pools and
    the sums), and the spawn and set-up seconds."""
    import tempfile

    import torch.distributed as dist

    from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
    from dcfa_yolo_tpu_torch.infer.pipeline import detect_batch_graph, predict, release_graphs
    from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo, init_model
    from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem, cuda_stem_train
    from dcfa_yolo_tpu_torch.ops.nms import _select_candidates
    from dcfa_yolo_tpu_torch.ops.resize import letterbox_batch_cf
    from dcfa_yolo_tpu_torch.parallel import dryrun, serve
    from dcfa_yolo_tpu_torch.parallel.mesh import init_process_group, run_calls, run_ranks
    from dcfa_yolo_tpu_torch.profile_train import synthetic_batch
    from dcfa_yolo_tpu_torch.train.trainer import Trainer
    from dcfa_yolo_tpu_torch.utils.profiling import (H100_BF16_FLOPS, H100_FP32_FLOPS,
                                                     bound, device_ms)

    hw, tc = (640, 640), TrainConfig()
    lr = tc.scaled_lrs()[0]
    host = synthetic_batch(8, hw, tc.max_boxes, SEED + 120)
    half = tuple(x[:4] for x in host)
    sd = {k: v.numpy() for k, v in init_model(
        ModelConfig(num_classes=1, phi="n", input_shape=hw), SEED, "cpu",
        train=True).state_dict().items()}
    cfg = lambda dt: dict(num_classes=1, phi="n", input_shape=hw, compute_dtype=dt,
                          train_stem_backend="kernel")
    base = dict(state_dict=sd, lr=lr, device="cuda:0", tf32=False, grad=True)
    rng = np.random.default_rng(SEED + 121)
    stem_in = dict(x=rng.random((8, 640, 640, 3), np.float32),
                   gy=rng.standard_normal((8, 320, 320, 16)).astype(np.float32),
                   kernel=(rng.standard_normal((16, 3, 3, 3)) * 0.3).astype(np.float32),
                   gamma=rng.standard_normal(16).astype(np.float32),
                   beta=(rng.standard_normal(16) * 0.1).astype(np.float32), eps=1e-5)
    r8, n8 = serve_inputs(8, SEED + 130)
    hw8 = np.tile([480.0, 640.0], (8, 1)).astype(np.float32)
    serve_kw = dict(conf_thres=0.001, iou_thres=0.5, max_det=300, pre_nms_topk=1024,
                    nms="kernel", stem="kernel")
    sizes = {"grad": (2678850, "float32"), "sums": (32, "float64")}
    calls = [
        (dryrun.stem_rank, (dict(stem_in, device="cuda:0", time_iters=20, sums=True),)),
        (dryrun.train_rank, (dict(base, cfg=cfg("float32"), batch=host, step_mode="fused",
                                  steps=3),)),
        (dryrun.train_rank, (dict(base, cfg=cfg("bfloat16"), batch=host,
                                  step_mode="fused"),)),
        (dryrun.train_rank, (dict(base, cfg=cfg("float32"), batch=half, per_rank=True,
                                  step_mode="split"),)),
        (serve.serve_rank, (dict(cfg=dict(num_classes=1, phi="n", input_shape=hw,
                                          compute_dtype="bfloat16"), seed=SEED,
                                 device="cuda:0", inputs=(r8, n8, hw8), kw=serve_kw,
                                 calls=2),)),
        (dryrun.allreduce_rank, (dict(device="cuda:0", sizes=sizes, iters=20),)),
    ]
    t_spawn = time.time()
    ranks = run_ranks(run_calls, 2, (calls,), backend="gloo", device="cuda", threads=2,
                      timeout_s=900)
    wall = time.time() - t_spawn
    stem_r, f32_r, bf16_r, split_r, serve_r, ar_r = zip(*ranks)
    setup_s = max(r["started"] for r in stem_r) - t_spawn
    launches = {"stem_train": sum(r["launches"]["stem_train"] - r["launches"]["stem_train_f32"]
                                  for r in bf16_r),
                "stem_train_f32": sum(r["launches"]["stem_train_f32"]
                                      for r in (*f32_r, *split_r)) + sum(
                                          r["launches"] for r in stem_r),
                "stem_eval": sum(r["launches"]["stem_eval"] for r in serve_r),
                "nms_suppress": sum(r["launches"]["nms_suppress"] for r in serve_r)}
    print(f"[dp] 2 gloo ranks on cuda:0: spawned, set up and run in {wall:.1f} s "
          f"(spawn and set-up {setup_s:.1f} s, to the later rank's first call); "
          f"launches {launches} | {CARD}")

    # kernel C across the ranks against one call on the b8 batch
    x = torch.from_numpy(stem_in["x"]).to(dev).requires_grad_(True)
    ps = [torch.from_numpy(stem_in[k]).to(dev).requires_grad_(True)
          for k in ("kernel", "gamma", "beta")]
    y, mean, var = cuda_stem_train.fused_train_stem(x, *ps, 1e-5)
    grads = torch.autograd.grad(y, [x, *ps], torch.from_numpy(stem_in["gy"]).to(dev))
    y, mean, var = (t.detach().cpu().numpy() for t in (y, mean, var))
    check(all(r["launches"] == 1 for r in stem_r), f"kernel C launches a rank: "
          f"{[r['launches'] for r in stem_r]}, expected 1")
    y_err = np.abs(np.concatenate([r["y"] for r in stem_r]) - y).max()
    m_err = max(rel_err(r["mean"], mean) for r in stem_r)
    v_err = max(rel_err(r["var"], var) for r in stem_r)
    g_err = {}
    for k, ref in zip(("x", "kernel", "gamma", "beta"), grads):
        ref = ref.cpu().numpy()
        got = (np.concatenate([r["d_x"] for r in stem_r]) if k == "x"
               else sum(r[f"d_{k}"] for r in stem_r))
        g_err[k] = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"[dp] kernel C over 2 ranks (b4 each) vs one b8 call, float32: y max err "
          f"{y_err:.3g} (tol {1e-4 * np.abs(y).max():.3g}), mean rel {m_err:.3g}, var rel "
          f"{v_err:.3g} (tol 1e-4), gradients rel to their largest {g_err} (tol 1e-4)")
    check(y_err <= 1e-4 * np.abs(y).max() and m_err <= 1e-4 and v_err <= 1e-4
          and max(g_err.values()) <= 1e-4, "kernel C across ranks disagrees with one call")
    # its sums over the group against the plain twin's over the group and
    # against one launch on the whole b8
    x8 = torch.from_numpy(stem_in["x"]).to(dev)
    sums8 = cuda_stem_train.stem_train(x8, ps[0].detach())[2].cpu().numpy()
    plain_err = max(rel_err(r["sums"], r["plain_sums"]) for r in stem_r)
    one_err = max(rel_err(r["sums"], sums8) for r in stem_r)
    same = all(np.array_equal(r["sums"], stem_r[0]["sums"]) for r in stem_r)
    print(f"[dp] kernel C sums all-reduced over the 2 ranks (b4 each, float32): against "
          f"stem_train_plain over the group rel {plain_err:.3g}, against one b8 launch rel "
          f"{one_err:.3g} (tol {stem_train_sum_tol(torch.float32):g}); equal on both ranks "
          f"{same}")
    check(same and max(plain_err, one_err) <= stem_train_sum_tol(torch.float32),
          "kernel C's sums across ranks disagree with its plain twin or one launch")

    def one_process(dtype, batch, steps):
        m = DCFAYolo(ModelConfig(**cfg(dtype)))
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        t = Trainer(m, TrainConfig(), device=dev)
        b = t.put_batch(*batch)
        out = dict(named=list(t._named), losses=[], ms=[])
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lb, g = t.step_with_grad(b, lr)
            out["losses"].append(float(lb.total))
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                out["grad"] = g.cpu().numpy()
                out["stats"] = {k: v.cpu().numpy() for k, v in t.state.batch_stats.items()}
        del t, m
        return out

    stats0 = {k: v for k, v in sd.items() if "running_" in k}
    refs = {}
    for what, got, dtype, batch, steps, loss_tol, cos_tol in (
            ("fused float32", f32_r, "float32", host, 3, 1e-4, 0.999),
            ("fused bf16", bf16_r, "bfloat16", host, 1, 0.02, 0.99),
            ("split float32", split_r, "float32", half, 1, 1e-4, 0.999)):
        ref = refs[what] = one_process(dtype, batch, steps)
        n = len(batch[0]) * hw[0] * hw[1]
        for r in got:
            check(r["digests"] == got[0]["digests"], f"[dp] {what}: the replicas differ")
        r = got[0]
        loss_rel = abs(r["terms"][0][0] - ref["losses"][0]) / abs(ref["losses"][0])
        leaves = leaf_cosines(grad_leaves(r["grad"], ref["named"]),
                              grad_leaves(ref["grad"], ref["named"]))
        zero = zero_leaves(leaves, cos_tol)
        held = {k: v[0] for k, v in leaves.items() if k not in zero}
        below = sorted(k for k, c in held.items() if not c >= cos_tol)
        for k in below[:8]:
            print(f"[dp] {what}: {k} cosine {leaves[k][0]:.6f}, max |Δ| "
                  f"{leaves[k][1]:.3g}, max |ref| {leaves[k][2]:.3g} of the gradient's "
                  f"largest entry")
        mom_err = 0.0
        if what != "split float32":
            dpm, onem = (stem_moments(s, stats0, n) for s in (r["batch_stats"], ref["stats"]))
            mom_err = max(rel_err(a, b) for mod in dpm for a, b in zip(dpm[mod], onem[mod]))
        mom_tol = stem_train_sum_tol(getattr(torch, dtype))
        stem_cos = min(leaves[f"backbone_{m}.stem.conv.weight"][0] for m in ("rgb", "nir"))
        worst = min(held.items(), key=lambda kv: kv[1])
        print(f"[dp] {what}, 2 ranks vs one process: loss {r['terms'][0][0]:.6f} vs "
              f"{ref['losses'][0]:.6f} (rel {loss_rel:.3g}, tol {loss_tol:g}); {len(leaves)} "
              f"gradient leaves, {len(held)} held to cosine >= {cos_tol}: min "
              f"{worst[1]:.7f} ({worst[0]}), {len(below)} under it; stem conv cosine "
              f"{stem_cos:.7f}; stem batch moments rel {mom_err:.3g} (tol {mom_tol:g}); "
              f"replicas equal after {len(r['digests'])} steps")
        print(f"[dp] {what}: {len(zero)} leaves under the cosine limit and zero in exact "
              f"arithmetic (reference and difference within {ABS_FLOOR:g} of the "
              f"gradient's largest entry; max "
              f"|ref| {max((leaves[k][2] for k in zero), default=0):.3g}, max |Δ| "
              f"{max((leaves[k][1] for k in zero), default=0):.3g}): {', '.join(zero)}")
        check(loss_rel <= loss_tol, f"[dp] {what}: loss off")
        check(mom_err <= mom_tol, f"[dp] {what}: stem batch moments rel {mom_err:.3g}")
        if what == "fused bf16":
            print(f"[dp] fused bf16 (cosines reported): stem conv cosine >= {cos_tol}: "
                  f"{stem_cos >= cos_tol}; leaves under {cos_tol}: {len(below)}")
        else:
            check(not below, f"[dp] {what}: gradient leaves below cosine {cos_tol}: {below}")
        if what == "fused float32":
            dp_ms = float(np.median([m for r in got for m in r["step_ms"][1:]]))
            one_ms = float(np.median(ref["ms"][1:]))
            print(f"[dp] fused float32 b8 step: 2 ranks (b4 each, one card, gloo) "
                  f"{dp_ms:.1f} ms, one process {one_ms:.1f} ms (host clock, steps 2-3, "
                  f"each ending in a synchronise); two ranks sharing one card measure "
                  f"no scaling | {CARD}")

    # how far bf16 alone moves the stem conv gradient: each bf16 gradient
    # against the float32 one on the same batch and weights, at b8 and b4
    named = refs["fused float32"]["named"]

    def stem_cosine(a, b):
        c = leaf_cosines(grad_leaves(a, named), grad_leaves(b, named))
        return min(c[f"backbone_{m}.stem.conv.weight"][0] for m in ("rgb", "nir"))

    bf16_b4 = one_process("bfloat16", half, 1)["grad"]
    f32_b8, f32_b4 = refs["fused float32"]["grad"], refs["split float32"]["grad"]
    print(f"[dp] bf16 stem conv gradient cosines (min of rgb, nir): 2 ranks vs one process "
          f"at b8 {stem_cosine(bf16_r[0]['grad'], refs['fused bf16']['grad']):.7f}; "
          f"against float32 on the same batch: 2 ranks b8 "
          f"{stem_cosine(bf16_r[0]['grad'], f32_b8):.7f}, one process b8 "
          f"{stem_cosine(refs['fused bf16']['grad'], f32_b8):.7f}, one process b4 "
          f"{stem_cosine(bf16_b4, f32_b4):.7f}")

    # serving: each rank's half against this process's b4 call on it
    check(all(r["replay_launches"] == {"stem_eval": 2, "nms_suppress": 1}
              for r in serve_r), f"[dp] serving launches a replay: "
          f"{[r['replay_launches'] for r in serve_r]}, expected A twice and B once")
    for i, r in enumerate(serve_r):
        sl = slice(4 * i, 4 * i + 4)
        ref = detect_batch_graph(model, r8[sl], n8[sl], hw8[sl],
                                 **{k: v for k, v in serve_kw.items()})
        bad = [f for f, v in r["result"].items()
               if not np.array_equal(v, getattr(ref, f).cpu().numpy())]
        check(not bad, f"[dp] serving rank {i} differs from the b4 call in {bad}")
    whole = detect_batch_graph(model, r8, n8, hw8, **serve_kw)
    dets = lambda res, j: tuple(np.asarray(res[f][j])[np.asarray(res["valid"][j])]
                                for f in ("boxes", "scores", "classes"))
    ranks_res = {f: np.concatenate([r["result"][f] for r in serve_r]) for f in
                 ("boxes", "scores", "classes", "valid")}
    whole_res = {f: getattr(whole, f).cpu().numpy() for f in ranks_res}
    served = [dets(ranks_res, j) for j in range(8)]
    ref = [dets(whole_res, j) for j in range(8)]
    counts, classes, box, score = per_image_agreement(served, nearest_slots(served, ref))
    print(f"[dp] serving: each rank's b4 half torch.equal to the b4 call; against the b8 "
          f"call (reported, bf16, matched by box): counts {counts}, classes equal "
          f"{classes}, max |Δbox| {box:.4g} px, max |Δscore| {score:.4g} ([trained]'s "
          f"bf16 limits 1 px, 0.005)")
    release_graphs(model)

    # kernels A, B and C at the local batch (b4), for the kernel table's
    # DP rows
    st = model.backbone_rgb.stem
    w, bias = cuda_stem.fold_stem_params(st.conv.weight, st.bn.weight, st.bn.bias,
                                         st.bn.running_mean, st.bn.running_var)
    canvas = letterbox_batch_cf(torch.from_numpy(r8[:4]).to(dev), hw).to(
        torch.bfloat16).contiguous()
    out, a_err, a_frac = stem_eval_held(canvas, w, bias, "[dp] b4")
    a_bound = bound(canvas.numel() * 2 + out.numel() * 2 + w.numel() * 2 + bias.numel() * 4,
                    2 * 4 * 640 * 640 * 16 * 27, H100_BF16_FLOPS)
    a_ms = device_ms(lambda: cuda_stem.stem_eval(canvas, w, bias), 50)
    a_plain = device_ms(lambda: cuda_stem.stem_eval_plain(canvas, w, bias), 10)
    a_lib = device_ms(lambda: stem_library(canvas, w, bias), 50)
    bk, sk, ck = predict(model, r8[:4], n8[:4], stem="kernel")
    _, top_s, _, alive, off = _select_candidates(bk, sk, ck.to(torch.int32),
                                                 torch.tensor(0.001, device=dev), 1024)
    b_t = time_nms(off.contiguous(), alive, 0.5, top_s)
    # what C must move at b4 float32: the input, both pools, the weights
    # and the (16, 2) sums
    xc4 = torch.from_numpy(stem_in["x"][:4]).to(dev)
    c_bound = bound(xc4.numel() * 4 + 2 * 4 * 320 * 320 * 16 * 4 + 16 * 27 * 4 + 32 * 4,
                    2 * 4 * 640 * 640 * 16 * 27, H100_FP32_FLOPS)
    kc = torch.from_numpy(stem_in["kernel"]).to(dev)
    _, c_res, _, c_sum_err, c_max = stem_train_held(xc4, kc, "[dp] b4 float32")
    c_ms = device_ms(lambda: cuda_stem_train.stem_train(xc4, kc), 20)
    c_plain = device_ms(lambda: cuda_stem_train.stem_train_plain(xc4, kc), 5)
    check(not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32),
          "[dp] TF32 is on for the float32 library call")

    def c_library():
        """C's function in cuDNN float32 (TF32 off): conv, both pools, the sums."""
        import torch.nn.functional as F

        c = F.conv2d(xc4.permute(0, 3, 1, 2), kc, padding=1)
        return (F.max_pool2d(c, 3, 2, 1), -F.max_pool2d(-c, 3, 2, 1),
                c.sum((0, 2, 3)), (c * c).sum((0, 2, 3)))

    c_lib = device_ms(c_library, 20)
    c_group_ms = float(np.median([r["ms"] for r in stem_r]))
    print(f"[dp] local batch b4 against the plain versions: A bit-equal {a_frac:.6f}, max "
          f"err {a_err.max().item():.4g} ([stem]'s limits); B keep masks equal; C float32 "
          f"pools max err {max(c_res['pmax'][0], c_res['pmin'][0]):.4g} (max|ĉ| "
          f"{c_max:.4g}), sums rel {c_sum_err:.3g} ([train_stem_f32]'s limits)")
    print(f"[dp] local batch b4, one rank's launch: A {a_ms:.4f} ms (plain {a_plain:.4f}, "
          f"library(cuDNN bf16 conv+pool+relu) {a_lib:.4f}, bound {a_bound[0]:.5f}, "
          f"{a_bound[1]}); B served b4 K=1024 {b_t['ms']:.4f} ms "
          f"(plain {b_t['plain_ms']:.2f}, bound {b_t['bound_ms']:.6f}, {b_t['bound_by']}); "
          f"C float32 {c_ms:.4f} ms alone (plain {c_plain:.4f}, library(cuDNN float32 "
          f"conv+both pools+sums, TF32 off) {c_lib:.4f}, bound {c_bound[0]:.5f}, "
          f"{c_bound[1]}), with its sums "
          f"all-reduced over the 2 gloo ranks {c_group_ms:.4f} ms (host clock, both ranks "
          f"on the card, the 256-byte all-reduce through the host) | {CARD}")

    # NCCL, world 1: the fused step through the group against no group
    # cuDNN's default algorithms need not repeat bit for bit, so this check
    # runs with deterministic ones
    store = tempfile.mkdtemp(prefix="dcfa_nccl_")
    cuda_stem_train.LAUNCHES = cuda_stem_train.LAUNCHES_F32 = 0
    group = init_process_group("nccl", "file://" + os.path.join(store, "store"), 0, 1, dev)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {}
        for name, g in (("nccl", group), ("none", None), ("none again", None)):
            m = DCFAYolo(ModelConfig(**cfg("float32")))
            m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
            t = Trainer(m, TrainConfig(), device=dev, step_mode="fused", group=g)
            b = t.put_batch(*host)
            for _ in range(2):
                t.train_step(b, lr)
            st = t.state
            runs[name] = {k: v.clone() for d in (st.params, st.batch_stats, st.ema)
                          for k, v in d.items()}
            del t, m
        nccl_ar = dryrun.allreduce_rank(0, 1, group, dict(device=dev, sizes=sizes, iters=20))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    launches["stem_train_f32"] += cuda_stem_train.LAUNCHES_F32
    differ = lambda a, b: [k for k in runs[a] if not torch.equal(runs[a][k], runs[b][k])]
    print(f"[dp] NCCL world 1, fused b8 float32, 2 steps: parameters, BN statistics and "
          f"EMA torch.equal to the trainer without a group: {not differ('nccl', 'none')} "
          f"({len(differ('nccl', 'none'))} entries differ); two runs without a group "
          f"equal: {not differ('none', 'none again')} (deterministic cuDNN)")
    gloo_ar = {k: float(np.median([r[k] for r in ar_r])) for k in sizes}
    print(f"[dp] all-reduce, host ms a call ending in a synchronise: flat gradient "
          f"(2,678,850 float32, 10.7 MB) gloo 2 ranks on one card {gloo_ar['grad']:.3f}, "
          f"NCCL world 1 {nccl_ar['grad']:.3f}; C's 256-byte float64 sums gloo "
          f"{gloo_ar['sums']:.4f}, NCCL {nccl_ar['sums']:.4f} | {CARD}")
    check(not differ("nccl", "none"), f"[dp] NCCL world 1 differs from no group: "
          f"{differ('nccl', 'none')[:5]}")
    return launches


def phase_bench():
    """The port's bench at BENCH_BATCH=32, BENCH_ITERS=5, with the stem and
    NMS kernels' launch counts read around it; its JSON on a line of its
    own."""
    from dcfa_yolo_tpu_torch import bench
    from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem

    os.environ.update(BENCH_BATCH="32", BENCH_ITERS="5")
    cuda_stem.LAUNCHES = cuda_nms.LAUNCHES = 0
    res = bench.run()
    launches = {"stem_eval": cuda_stem.LAUNCHES, "nms_suppress": cuda_nms.LAUNCHES}
    print(f"[bench] launches {launches}")
    print(json.dumps(res))
    check(np.isfinite(res["value"]) and res["value"] > 0 and res["mfu"] <= 1.0,
          f"bench: implausible result {res['value']} pairs/s, mfu {res['mfu']}")
    check(launches["stem_eval"] > 0 and launches["nms_suppress"] > 0,
          f"the bench did not launch the stem and NMS kernels: {launches}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    if importlib.util.find_spec("dcfa_yolo_tpu_torch") is None:
        print("chip_smoke: run it from a checkout of the repository (package "
              "dcfa_yolo_tpu_torch not found)", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from dcfa_yolo_tpu_torch.config import ModelConfig
    from dcfa_yolo_tpu_torch.models.yolo import init_model

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    try:
        phase_device()
        phase_build()
        model = init_model(ModelConfig(num_classes=1, phi="n", input_shape=(640, 640),
                                       compute_dtype="bfloat16"), SEED, dev)
        stem_t = phase_stem(model, dev)
        phase_nms(dev)
        launches, nms_t = phase_serve(dev)
        train_stem_t = phase_train_stem(dev)
        train_stem_f32_t = phase_train_stem(dev, torch.float32)
        train_n = phase_train(dev)
        launches["stem_train"] = train_n["stem_train"]
        remat_n = phase_remat(dev)
        data = train_data(32)
        try:
            launches.update(phase_train_cli(dev, data))
            launches["stem_train_f32"] += train_n["stem_train_f32"]
            phase_device_aug(dev, data)
        finally:
            shutil.rmtree(data[0], ignore_errors=True)
        for name, n in remat_n.items():
            launches[name] += n
        probe_t = phase_probe(dev)
        phase_deploy(dev)
        phase_graph(dev)
        data_dir, pairs = synth_pairs(8)
        try:
            trained = phase_trained(dev, pairs)
            phase_cli(dev, data_dir)
            for name, n in phase_interop(dev, pairs, trained).items():
                launches[name] += n
            for name, n in phase_variants(dev, pairs).items():
                launches[name] += n
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        for phase in (phase_scales, phase_phis):
            for name, n in phase(dev).items():
                launches[name] += n
        for name, n in phase_dp(dev, model).items():
            launches[name] += n
        phase_bench()
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    probe_src = "dcfa_yolo_tpu_torch/csrc/stem_probe.cu"
    kernels = []
    for name, src, rep, t, n in (
            ("stem_eval", "dcfa_yolo_tpu_torch/csrc/stem_eval.cu",
             "dcfa_yolo_tpu/ops/pallas_stem.py:200", stem_t, launches["stem_eval"]),
            ("nms_suppress", "dcfa_yolo_tpu_torch/csrc/nms_suppress.cu",
             "dcfa_yolo_tpu/ops/pallas_nms.py:40", nms_t, launches["nms_suppress"]),
            ("stem_train", "dcfa_yolo_tpu_torch/csrc/stem_train.cu",
             "dcfa_yolo_tpu/ops/pallas_stem_train.py:82", train_stem_t,
             launches["stem_train"]),
            ("stem_train_f32", "dcfa_yolo_tpu_torch/csrc/stem_train.cu",
             "dcfa_yolo_tpu/ops/pallas_stem_train.py:82", train_stem_f32_t,
             launches["stem_train_f32"]),
            *((f"stem_probe_{v}", probe_src,
               "tools/stem_split_probe.py:" + ("112" if v == "pipe" else "49"),
               probe_t[v], probe_t[v]["launches"])
              for v in ("conv", "pool", "dblbuf", "pipe"))):
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=n, max_abs_err=t["max_abs_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"]))
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
