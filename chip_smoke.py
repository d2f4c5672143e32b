#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dcfa_yolo_tpu_torch`) on one NVIDIA
Hopper GPU: builds the hand-written kernels from `dcfa_yolo_tpu_torch/csrc/`,
holds each against its plain PyTorch version at its path's shapes, times it,
then drives the paths of the port at phi='n' 640²: serving through
`YOLOPredictor` in bf16 (kernels A and B), training through
`Trainer.train_step` in bf16 (kernel C), the training CLI
(`python -m dcfa_yolo_tpu_torch.train`, in-process) in float32 (kernel C's
float32 instantiation, and kernel B in its mAP epoch), the stem split probe
(kernel A and its four variants, all on A's core), the deploy serving
graph, the captured serving pipeline (`detect_batch_graph`, kernels A and
B inside one CUDA graph a key, held bit-equal to the eager pipeline), the
trained-weights fixture served end to end, the serving CLIs
(`python -m dcfa_yolo_tpu_torch.predict` / `.get_map`, in-process), weights
in and out (the reference's `.pth` against its own outputs and served
through the graph, the export to its `.npz` and back, the `torch.export`
artifact of the deploy pipeline) and the bench; it checks that each path went through its kernels and agrees with
its all-plain (or train-graph, or eager) version.

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
    def held(canvas, what):
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

    # the f32 sums run in another order (per-CTA partials, then a fixed
    # reduction over CTAs): relative to each channel's magnitude
    sum_tol = 1e-4 if f32 else 1e-3

    def held(x, k, what):
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
        check(sum_err <= sum_tol, f"train stem {what} sums: relative error {sum_err:.3g} "
              f"> {sum_tol:g}")
        return pmax, res, sums, sum_err, c_max

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
    launch counts read around exactly those steps; then one step of the
    'kernel' graph against one of the 'plain' graph from the same weights,
    in bf16 (loss within 2%, stem-kernel gradient cosine ≥ 0.99) and in
    float32 (loss within 1e-4 relative, cosine ≥ 0.999)."""
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
    # the kernel graph against the plain graph, one step from the same weights
    for dtype, loss_tol, cos_tol in (("bfloat16", 0.02, 0.99), ("float32", 1e-4, 0.999)):
        out = {}
        for backend in ("kernel", "plain"):
            c = dataclasses.replace(cfg, train_stem_backend=backend, compute_dtype=dtype)
            t = Trainer(init_model(c, SEED, dev, train=True), tc, device=dev)
            check(t.train_stem == backend, f"{backend!r} resolved to {t.train_stem!r}")
            bt = t.put_batch(*host_batch)
            lb = t.loss(t.forward(bt), bt)
            grads = t.backward(lb.total)
            names = [n for n, _ in t._named]
            out[backend] = (float(lb.total.detach()),
                            grads[names.index("backbone_rgb.stem.conv.weight")].flatten(),
                            grads[names.index("backbone_nir.stem.conv.weight")].flatten())
            del t, grads, bt, lb
        loss_rel = abs(out["kernel"][0] - out["plain"][0]) / abs(out["plain"][0])
        cos = [float(torch.nn.functional.cosine_similarity(out["kernel"][i], out["plain"][i], 0))
               for i in (1, 2)]
        print(f"[train] {dtype} kernel vs plain stem graph, one step from the same weights: "
              f"loss {out['kernel'][0]:.6f} vs {out['plain'][0]:.6f} (rel {loss_rel:.3g}, tol "
              f"{loss_tol:g}), stem conv-kernel gradient cosine rgb {cos[0]:.7f} nir "
              f"{cos[1]:.7f} (tol {cos_tol:g})")
        check(loss_rel <= loss_tol and min(cos) >= cos_tol,
              f"{dtype} kernel stem graph disagrees with the plain graph")
    return launches


def phase_train_cli(dev):
    """The training CLI (`python -m dcfa_yolo_tpu_torch.train`) in-process
    at phi='n' 640² float32, full width, `--train-stem pallas`, fold-shuffle,
    mosaic and mixup on (the defaults), on a 32-pair synthetic dataset
    (480×360 PNG pairs, 24 train / 8 val): 2 epochs with mAP at epoch 2,
    then `--resume` from the last checkpoint for a third.  Launch counts are
    read around each run; a checkpoint must load into the unfolded graph and
    compute the folded EMA model's eval forward (tests/test_torch_model.py's
    float32 tolerances)."""
    import tempfile

    from dcfa_yolo_tpu_torch.config import ModelConfig
    from dcfa_yolo_tpu_torch.data import voc
    from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo
    from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem, cuda_stem_train
    from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset
    from dcfa_yolo_tpu_torch.train.__main__ import run
    from dcfa_yolo_tpu_torch.utils.checkpoint import load_checkpoint, load_variables

    def reset():
        cuda_stem.LAUNCHES = cuda_nms.LAUNCHES = 0
        cuda_stem_train.LAUNCHES = cuda_stem_train.LAUNCHES_F32 = 0

    def counts():
        torch.cuda.synchronize()
        return {"stem_train_f32": cuda_stem_train.LAUNCHES_F32,
                "stem_train": cuda_stem_train.LAUNCHES,
                "stem_eval": cuda_stem.LAUNCHES, "nms_suppress": cuda_nms.LAUNCHES}

    def lines(path):
        with open(path) as f:
            return [l.strip() for l in f if l.strip()]

    def tf32():
        return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    # the CLI sets its own precision: start it from PyTorch's defaults, as a
    # fresh process would, not from this script's TF32-off setting
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        make_dataset(tmp, 32)
        devkit = os.path.join(tmp, "VOCdevkit")
        voc.generate_imagesets(devkit, trainval_percent=1.0, train_percent=0.75)
        classes = os.path.join(tmp, "model_data", "voc_classes.txt")
        voc.generate_annotation_files(devkit, classes, out_dir=tmp, image_ext=".png")
        n_train = len(lines(os.path.join(tmp, "2007_train.txt")))
        n_val = len(lines(os.path.join(tmp, "2007_val.txt")))
        print(f"[train_cli] synthetic dataset: {n_train} train + {n_val} val pairs, "
              f"480×360 PNG ({time.perf_counter() - t0:.1f} s)")
        common = ["--classes-path", classes,
                  "--train-annotation", os.path.join(tmp, "2007_train.txt"),
                  "--val-annotation", os.path.join(tmp, "2007_val.txt"),
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
        del r1, r2
    return {"stem_train_f32": n1["stem_train_f32"] + n2["stem_train_f32"]}


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

    def per_image(served, ref):
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
        counts, classes, box, score = per_image(served, ref)
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
            counts, classes, box, score = per_image(served, eager(pred.model, "plain"))
            print(f"[trained] bf16 served graph vs the bf16 ConvMaxpool stem and plain "
                  f"NMS (reported): counts equal {all(c == k for c, k in counts)}, "
                  f"classes equal {classes}, max |Δbox| {box:.4g} px, max |Δscore| "
                  f"{score:.4g} (slot by slot)")
        pred.release_graphs()
    counts, classes, box, score = per_image(held["bfloat16"], held["float32"])
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
        launches["stem_train"] = phase_train(dev)["stem_train"]
        launches.update(phase_train_cli(dev))
        probe_t = phase_probe(dev)
        phase_deploy(dev)
        phase_graph(dev)
        data_dir, pairs = synth_pairs(8)
        try:
            trained = phase_trained(dev, pairs)
            phase_cli(dev, data_dir)
            for name, n in phase_interop(dev, pairs, trained).items():
                launches[name] += n
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
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
