#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dcfa_yolo_tpu_torch`) on one NVIDIA
Hopper GPU: builds the hand-written kernels from `dcfa_yolo_tpu_torch/csrc/`,
holds each against its plain PyTorch version at the serving path's shapes,
times it, then serves the phi='n' 640² bf16 model through `YOLOPredictor`
and checks that the path went through both kernels and agrees with the
all-plain path.

    python3 chip_smoke.py

Prints one line per phase, then a JSON line with every kernel's numbers,
then `{"ok": true, "device": {...}}` as the last line.  Any failed check
exits non-zero before that line; so does a machine without CUDA.  TF32 is
off throughout: the float32 plain versions are compared in full float32.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12     # dense tensor-core bf16
H100_FP32_FLOPS = 67e12      # CUDA-core float32
SEED = 0


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of one call, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops, peak):
    t_b, t_o = nbytes / H100_BYTES_PER_S, ops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card)
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
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "Used" in line:
                print(f"[build] {name}: {line.strip()}")


def serve_inputs(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, 480, 640, 3), dtype=np.uint8),
            rng.integers(0, 256, (b, 480, 640, 3), dtype=np.uint8))


def phase_stem(model, dev):
    """Kernel A vs stem_eval_plain at the serving path's shape (b8 640²,
    the letterboxed canvas of 480×640 pairs, weights of the served model)."""
    import torch.nn.functional as F
    from dcfa_yolo_tpu_torch.ops import cuda_stem
    from dcfa_yolo_tpu_torch.ops.resize import letterbox_batch_cf

    st = model.backbone_rgb.stem
    w, bias = cuda_stem.fold_stem_params(st.conv.weight, st.bn.weight, st.bn.bias,
                                         st.bn.running_mean, st.bn.running_var)
    res = {}
    for b in (8, 1):
        rgb, _ = serve_inputs(b, SEED + 1)
        canvas = letterbox_batch_cf(torch.from_numpy(rgb).to(dev), (640, 640))
        canvas = canvas.to(torch.bfloat16).contiguous()
        out = cuda_stem.stem_eval(canvas, w, bias)
        torch.cuda.synchronize()
        ref = cuda_stem.stem_eval_plain(canvas, w, bias)
        o, r = out.float(), ref.float()
        err = (o - r).abs()
        frac = (o == r).float().mean().item()
        ok = bool(torch.all(err <= 0.03 + 0.02 * r.abs())) and frac >= 0.999
        check(bool(torch.isfinite(o).all()), "stem kernel output not finite")
        check(ok, f"stem b{b}: {frac:.6f} bit-equal (need 0.999), max err "
              f"{err.max().item():.4g} (atol 0.03, rtol 0.02)")
        w_lib = w
        b_lib = bias.to(torch.bfloat16)

        def library():
            y = F.conv2d(canvas, w_lib, b_lib)
            return torch.relu(F.max_pool2d(y, 3, 2, 1))

        nbytes = canvas.numel() * 2 + out.numel() * 2 + w.numel() * 2 + bias.numel() * 4
        flops = 2 * b * 640 * 640 * 16 * 27
        bound_ms, bound_by = bound(nbytes, flops, H100_BF16_FLOPS)
        res[b] = dict(
            max_abs_err=err.max().item(), bit_equal=frac,
            ms=cuda_ms(lambda: cuda_stem.stem_eval(canvas, w, bias), 50),
            plain_ms=cuda_ms(lambda: cuda_stem.stem_eval_plain(canvas, w, bias), 10),
            library_ms=cuda_ms(library, 50),
            bound_ms=bound_ms, bound_by=bound_by)
        print(f"[stem] b{b} 640²: bit-equal {frac:.6f}, max_abs_err "
              f"{res[b]['max_abs_err']:.4g} | kernel_ms {res[b]['ms']:.4f} "
              f"plain_ms {res[b]['plain_ms']:.4f} library_ms(cuDNN conv+pool+relu) "
              f"{res[b]['library_ms']:.4f} bound_ms {bound_ms:.5f} ({bound_by})")
    return res[8]


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


def time_nms(boxes, alive, thr, scores=None):
    from dcfa_yolo_tpu_torch.ops import cuda_nms

    b, k = alive.shape
    keep = cuda_nms.greedy_suppress(boxes, alive, thr)
    torch.cuda.synchronize()
    ref = cuda_nms.greedy_suppress_plain(boxes, alive, thr)
    check(torch.equal(keep, ref), f"NMS keep mask differs from the plain "
          f"version at B={b}, K={k}: {(keep != ref).sum().item()} entries")
    lib_ms = None
    if importlib.util.find_spec("torchvision") is not None and scores is not None:
        import torchvision

        # one call over every image's alive candidates, images kept apart by
        # index (classes are already apart by the coordinate offset)
        img = torch.arange(b, device=boxes.device)[:, None].expand(b, k)
        lib_ms = cuda_ms(lambda: torchvision.ops.batched_nms(
            boxes[alive], scores[alive], img[alive], thr), 10)
    pairs = nms_pairs(boxes, alive, thr)
    bound_ms, bound_by = bound(b * k * 18, 12 * pairs, H100_FP32_FLOPS)
    return dict(
        max_abs_err=float((keep.int() - ref.int()).abs().max()),
        kept=int(ref.sum()), pairs=pairs,
        ms=cuda_ms(lambda: cuda_nms.greedy_suppress(boxes, alive, thr), 20),
        plain_ms=cuda_ms(lambda: cuda_nms.greedy_suppress_plain(boxes, alive, thr), 2, 1),
        library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_nms(dev):
    """Kernel B vs greedy_suppress_plain on clustered seeded boxes with IoUs
    exactly at the threshold and all-dead images: keep masks must be equal."""
    k = 1024
    for b in (1, 8, 32):
        rng = np.random.default_rng(SEED + b)
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
        t = time_nms(torch.from_numpy(boxes).to(dev), torch.from_numpy(alive).to(dev),
                     0.5, torch.from_numpy(scores).to(dev))
        lib = "null" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        print(f"[nms] B={b} K={k}: keep masks equal (kept {t['kept']}, "
              f"{t['pairs']} IoU pairs) | kernel_ms {t['ms']:.4f} plain_ms "
              f"{t['plain_ms']:.2f} library_ms {lib} bound_ms "
              f"{t['bound_ms']:.6f} ({t['bound_by']})")


def phase_serve(dev):
    """The main path: YOLOPredictor at phi='n', 640², bf16, conf 0.001 —
    three single-pair requests, then one b8 batch, with the launch counts
    read around exactly that run."""
    from dcfa_yolo_tpu_torch.infer.pipeline import predict
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
    from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem
    from dcfa_yolo_tpu_torch.ops.nms import _select_candidates, batched_nms

    kw = dict(input_shape=(640, 640), phi="n", confidence=0.001, nms_iou=0.5,
              compute_dtype="bfloat16", seed=SEED)
    pred = YOLOPredictor(["object"], **kw)
    singles = [serve_inputs(1, SEED + 10 + i) for i in range(3)]
    rgb8, nir8 = serve_inputs(8, SEED + 20)

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
    nms_kw = dict(conf_thres=0.001, iou_thres=0.5, pre_nms_topk=1024, max_det=300)
    rk = batched_nms(bk, sk, ck, backend="kernel", **nms_kw)
    rp = batched_nms(bk, sk, ck, backend="plain", **nms_kw)
    for name in rk._fields:
        check(torch.equal(getattr(rk, name), getattr(rp, name)),
              f"NMS {name} differs between kernel and plain on the served predictions")
    print(f"[serve] NMS kernel == plain on the served b8 predictions "
          f"(valid {rk.valid.sum(-1).tolist()}, candidates {rk.n_candidates.tolist()})")
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
          f"({nms_t['bound_by']}, {nms_t['pairs']} IoU pairs)")

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
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, src, rep, t in (
            ("stem_eval", "dcfa_yolo_tpu_torch/csrc/stem_eval.cu",
             "dcfa_yolo_tpu/ops/pallas_stem.py:200", stem_t),
            ("nms_suppress", "dcfa_yolo_tpu_torch/csrc/nms_suppress.cu",
             "dcfa_yolo_tpu/ops/pallas_nms.py:40", nms_t)):
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=t["max_abs_err"], ms=t["ms"],
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
