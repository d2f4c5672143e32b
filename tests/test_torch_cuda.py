"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here is marked `cuda` and
skips without a GPU.  The file imports no JAX (the machine with the card
has none); run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

TF32 is off for the float32 plain versions (cuDNN would otherwise round the
stem conv to TF32).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dcfa_yolo_tpu_torch.ops import _build, cuda_nms, cuda_stem, cuda_stem_train

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the shapes the persistent tile walk can get wrong: b1 and b3, 320² and
# 1280², and tiles that do not divide the image
EDGE_SHAPES = [(2, 64, 130), (1, 640, 640), (3, 30, 18), (1, 66, 66), (3, 640, 640),
               (1, 320, 320), (3, 320, 320), (1, 1280, 1280)]


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_stem_kernel_matches_plain(cuda, shape):
    b, h, w = shape
    rng = np.random.default_rng(h * w)
    canvas = np.zeros((b, 3, h + 2, w + 2), np.float32)
    canvas[:, :, 1:-1, 1:-1] = rng.integers(0, 256, (b, 3, h, w))
    k = torch.from_numpy((rng.standard_normal((16, 3, 3, 3)) * 0.3).astype(np.float32))
    gamma, beta, mean = (torch.from_numpy((rng.standard_normal(16) * s + m).astype(np.float32))
                         for s, m in ((0.2, 1.0), (0.2, 0.0), (0.1, 0.0)))
    var = torch.from_numpy((rng.random(16) + 0.5).astype(np.float32))
    w_f, bias = (t.to(cuda) for t in cuda_stem.fold_stem_params(k, gamma, beta, mean, var))
    x = torch.from_numpy(canvas).to(cuda, torch.bfloat16)
    before = _build.launches()
    out = cuda_stem.stem_eval(x, w_f, bias)
    torch.cuda.synchronize()
    assert _build.launches(before)["stem_eval"] == 1
    ref = cuda_stem.stem_eval_plain(x, w_f, bias)
    out, ref = out.float().cpu().numpy(), ref.float().cpu().numpy()
    np.testing.assert_allclose(out, ref, atol=0.03, rtol=0.02)
    assert (out == ref).mean() >= 0.999


@pytest.mark.parametrize("name", ["stem_eval", "stem_train_bf16", "stem_train_f32",
                                  "stem_grad1_bf16", "stem_grad2_bf16", "stem_grad1_f32",
                                  "stem_grad2_f32", "stem_probe_conv", "stem_probe_pool",
                                  "stem_probe_dblbuf", "stem_probe_pipe"])
def test_stem_kernels_fit_two_ctas_an_sm(cuda, name):
    """The kernels on the stem core (A, C and C's backward's two passes,
    the probe's four variants): at
    most 128 registers a thread and no stack, so that at least two CTAs
    (of 256 threads; pipe's of 384) are resident on every SM."""
    from dcfa_yolo_tpu_torch.ops import _build

    info = _build.stem_kernel_info(name, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert info["registers"] <= 128 and info["stack_bytes"] == 0, info
    assert info["resident_ctas"] >= 2 * sms, info


def _boxes(rng, b, k):
    cxy = rng.uniform(20, 80, (b, 4, 2))[np.arange(b)[:, None], rng.integers(0, 4, (b, k))]
    cxy = cxy + rng.normal(0, 3, (b, k, 2))
    wh = rng.uniform(8, 24, (b, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    boxes[:, 0:k - 1:7] = [0, 0, 8, 4]     # IoU exactly 0.5 with the next box
    boxes[:, 1:k:7] = [0, 0, 4, 4]
    return boxes


# kernel B's (B, K): K = 1 and 33 (one word, a ragged word), the serving
# K = 1024 at b1 / b9 / b32, K = 2048, and the eval's K = 8400 (W = 264 words)
NMS_SHAPES = [(1, 1), (1, 33), (8, 300), (1, 1024), (9, 1024), (32, 1024), (1, 2048),
              (8, 8400)]


def _nms_inputs(cuda, b, k):
    rng = np.random.default_rng(b * k)
    boxes = torch.from_numpy(_boxes(rng, b, k)).to(cuda)
    alive = torch.from_numpy(rng.random((b, k)) < 0.8).to(cuda)
    if b > 1:
        alive[-1] = False  # an all-dead image
    return boxes, alive


@pytest.mark.parametrize("b,k", NMS_SHAPES)
def test_nms_kernel_matches_plain_exactly(cuda, b, k):
    boxes, alive = _nms_inputs(cuda, b, k)
    for thr in (0.5, 0.3, 0.7):
        before = _build.launches()
        keep = cuda_nms.greedy_suppress(boxes, alive, thr)
        torch.cuda.synchronize()
        assert _build.launches(before)["nms_suppress"] == 1
        ref = cuda_nms.greedy_suppress_plain(boxes, alive, thr)
        assert torch.equal(keep, ref)
        if b > 1:
            assert not keep[-1].any()


@pytest.mark.parametrize("b,k", NMS_SHAPES)
def test_nms_kernel_mask_words_match_plain(cuda, b, k):
    """Phase 1's words, in the kernel's layout, equal suppress_mask_plain's
    wherever the scan reads them, and the plain scan over the kernel's
    words gives the kernel's keep mask."""
    boxes, alive = _nms_inputs(cuda, b, k)
    for thr in (0.5, 0.3):
        keep, mask = cuda_nms.greedy_suppress_with_mask(boxes, alive, thr)
        torch.cuda.synchronize()
        ref = cuda_nms.suppress_mask_plain(boxes, alive, thr)
        reads = cuda_nms.scan_reads(alive)
        assert mask.shape == ref.shape
        assert torch.equal(mask[reads], ref[reads])
        assert torch.equal(cuda_nms.scan_keep_plain(mask, alive), keep)


def test_nms_kernel_past_whole_block_staging(cuda):
    """K = 30,000: two whole 32-row blocks (W = 940 words) no longer fit
    the scan's shared memory, so it stages 128-word chunks of each row."""
    rng = np.random.default_rng(30000)
    cxy = rng.uniform(0, 4000, (1, 30000, 2))  # sparse: many candidates kept
    wh = rng.uniform(20, 90, (1, 30000, 2))
    boxes = torch.from_numpy(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
                             .astype(np.float32)).to(cuda)
    alive = torch.from_numpy(rng.random((1, 30000)) < 0.8).to(cuda)
    assert cuda_nms._build.load_library().nms_scan_smem(30000) > 0
    keep, mask = cuda_nms.greedy_suppress_with_mask(boxes, alive, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(keep, cuda_nms.greedy_suppress_plain(boxes, alive, 0.5))
    reads = cuda_nms.scan_reads(alive)
    assert torch.equal(mask[reads], cuda_nms.suppress_mask_plain(boxes, alive, 0.5)[reads])


@pytest.mark.parametrize("b,k", [(8, 1024), (1, 8400)])
def test_nms_kernel_two_launches_bit_identical(cuda, b, k):
    boxes, alive = _nms_inputs(cuda, b, k)
    k1, m1 = cuda_nms.greedy_suppress_with_mask(boxes, alive, 0.5)
    k2, m2 = cuda_nms.greedy_suppress_with_mask(boxes, alive, 0.5)
    torch.cuda.synchronize()
    reads = cuda_nms.scan_reads(alive)
    assert torch.equal(k1, k2) and torch.equal(m1[reads], m2[reads])


@pytest.mark.parametrize("topk", [1024, 2048])
def test_batched_nms_kernel_matches_plain(cuda, topk):
    """batched_nms on 2 images of 8400 anchors, all above conf 0.001: every
    output field equal between the kernel and the plain suppression, past
    the old kernel's K = 1024."""
    from dcfa_yolo_tpu_torch.ops.nms import batched_nms

    rng = np.random.default_rng(topk)
    boxes = torch.from_numpy(_boxes(rng, 2, 8400) * 8).to(cuda)
    scores = torch.from_numpy((rng.integers(1, 65, (2, 8400)) / 64).astype(np.float32)).to(cuda)
    classes = torch.from_numpy(rng.integers(0, 2, (2, 8400)).astype(np.int32)).to(cuda)
    kw = dict(conf_thres=0.001, iou_thres=0.5, pre_nms_topk=topk, max_det=300)
    rk = batched_nms(boxes, scores, classes, backend="kernel", **kw)
    rp = batched_nms(boxes, scores, classes, backend="plain", **kw)
    for name in rk._fields:
        assert torch.equal(getattr(rk, name), getattr(rp, name)), name
    assert rk.valid.any()


@pytest.mark.parametrize("shape", EDGE_SHAPES + [(16, 640, 640)])
def test_train_stem_kernel_matches_plain(cuda, shape):
    """Kernel C against stem_train_plain: pools in the v4 class (only the
    conv's f32 summation order differs), per-channel sums to 1e-3 relative
    (f32 sums in another order); a second launch repeats the sums bit for
    bit."""
    b, h, w = shape
    rng = np.random.default_rng(h + w)
    x = torch.from_numpy(rng.random((b, h, w, 3), np.float32)).to(cuda, torch.bfloat16)
    k = torch.from_numpy((rng.standard_normal((16, 3, 3, 3)) * 0.3).astype(np.float32))
    k = k.to(cuda, torch.bfloat16)
    before = _build.launches()
    pmax, pmin, sums = cuda_stem_train.stem_train(x, k)
    torch.cuda.synchronize()
    assert _build.launches(before)["stem_train"] == 1
    rmax, rmin, rsums = cuda_stem_train.stem_train_plain(x, k)
    for got, ref in ((pmax, rmax), (pmin, rmin)):
        got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
        np.testing.assert_allclose(got, ref, atol=0.03, rtol=0.02)
        assert (got == ref).mean() >= 0.999
    np.testing.assert_allclose(sums.cpu().numpy(), rsums.cpu().numpy(), rtol=1e-3,
                               atol=1e-3 * rsums.abs().max().item())
    assert torch.equal(cuda_stem_train.stem_train(x, k)[2], sums)


@pytest.mark.parametrize("shape", EDGE_SHAPES + [(16, 640, 640)])
def test_train_stem_f32_kernel_matches_plain(cuda, shape):
    """Kernel C's float32 instantiation against stem_train_plain: only the
    conv's f32 summation order differs, so the pools agree within 1e-5 of
    max|ĉ| plus 1e-5 relative and the sums within 1e-4 relative; the launch
    is counted under stem_train and stem_train_f32, and a second launch
    repeats the sums bit for bit."""
    b, h, w = shape
    rng = np.random.default_rng(h * w + 1)
    x = torch.from_numpy(rng.random((b, h, w, 3), np.float32)).to(cuda)
    k = torch.from_numpy((rng.standard_normal((16, 3, 3, 3)) * 0.3).astype(np.float32)).to(cuda)
    before = _build.launches()
    pmax, pmin, sums = cuda_stem_train.stem_train(x, k)
    torch.cuda.synchronize()
    assert _build.launches(before) == {"stem_train": 1, "stem_train_f32": 1}
    assert pmax.dtype == pmin.dtype == torch.float32
    rmax, rmin, rsums = cuda_stem_train.stem_train_plain(x, k)
    c_max = max(rmax.abs().max().item(), rmin.abs().max().item())
    for got, ref in ((pmax, rmax), (pmin, rmin)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5,
                                   atol=1e-5 * c_max)
    np.testing.assert_allclose(sums.cpu().numpy(), rsums.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * rsums.abs().max().item())
    assert torch.equal(cuda_stem_train.stem_train(x, k)[2], sums)


def test_train_stem_f32_launches_on_two_streams_keep_their_weights(cuda):
    """The float32 kernel reads its weights from one constant-memory buffer
    written on the launch's stream; launches on two streams with different
    weights each get their own (the wrapper orders the streams)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((2, 64, 130, 3), np.float32)).to(cuda)
    ks = [torch.from_numpy((rng.standard_normal((16, 3, 3, 3)) * 0.3).astype(np.float32)).to(cuda)
          for _ in range(2)]
    side = torch.cuda.Stream(cuda)
    first = cuda_stem_train.stem_train(x, ks[0])
    with torch.cuda.stream(side):
        second = cuda_stem_train.stem_train(x, ks[1])
    torch.cuda.synchronize()
    for got, k in ((first, ks[0]), (second, ks[1])):
        ref = cuda_stem_train.stem_train_plain(x, k)
        c_max = max(ref[0].abs().max().item(), ref[1].abs().max().item())
        for g, r in zip(got[:2], ref[:2]):
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=1e-5,
                                       atol=1e-5 * c_max)


def test_train_stem_kernel_across_two_gloo_ranks(cuda, tmp_path):
    """Kernel C on 2 gloo ranks sharing this card, each on its half of a b4
    batch, with the float64 sums all-reduced: the group's sums against one
    launch on the whole batch and against the plain twin with the same
    group (1e-4 relative, float32); the differentiable stem's y and moments
    against the one-process call; one launch a rank."""
    from dcfa_yolo_tpu_torch.ops import _build
    from dcfa_yolo_tpu_torch.parallel import dryrun
    from dcfa_yolo_tpu_torch.parallel.mesh import run_ranks

    _build.load_library()  # the ranks only load it
    rng = np.random.default_rng(12)
    spec = dict(x=rng.random((4, 64, 130, 3), np.float32),
                gy=rng.standard_normal((4, 32, 65, 16)).astype(np.float32),
                kernel=(rng.standard_normal((16, 3, 3, 3)) * 0.3).astype(np.float32),
                gamma=rng.standard_normal(16).astype(np.float32),
                beta=(rng.standard_normal(16) * 0.1).astype(np.float32),
                device="cuda:0", sums=True)
    ranks = run_ranks(dryrun.stem_rank, 2, (spec,), backend="gloo", device="cuda",
                      store_dir=str(tmp_path))
    x = torch.from_numpy(spec["x"]).to(cuda)
    k, g, b = (torch.from_numpy(spec[n]).to(cuda) for n in ("kernel", "gamma", "beta"))
    sums = cuda_stem_train.stem_train(x, k)[2].cpu().numpy()
    y, mean, var = (t.cpu().numpy() for t in cuda_stem_train.fused_train_stem(x, k, g, b, 1e-5))
    for r in ranks:
        assert r["launches"] == 1
        for got in (r["sums"], r["plain_sums"]):
            np.testing.assert_allclose(got, sums, rtol=1e-4, atol=1e-4 * np.abs(sums).max())
        np.testing.assert_allclose(r["mean"], mean, rtol=1e-4)
        np.testing.assert_allclose(r["var"], var, rtol=1e-4)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]), y, rtol=0,
                               atol=1e-4 * np.abs(y).max())


def _probe_inputs(cuda, b, h, w):
    """A random uint8 canvas with its zero border and fold_stem_params
    weights of a random stem, on the card."""
    rng = np.random.default_rng(b * h + w)
    canvas = np.zeros((b, 3, h + 2, w + 2), np.float32)
    canvas[:, :, 1:-1, 1:-1] = rng.integers(0, 256, (b, 3, h, w))
    k = torch.from_numpy((rng.standard_normal((16, 3, 3, 3)) * 0.3).astype(np.float32))
    gamma, beta, mean = (torch.from_numpy((rng.standard_normal(16) * s + m).astype(np.float32))
                         for s, m in ((0.2, 1.0), (0.2, 0.0), (0.1, 0.0)))
    var = torch.from_numpy((rng.random(16) + 0.5).astype(np.float32))
    w_f, bias = (t.to(cuda) for t in cuda_stem.fold_stem_params(k, gamma, beta, mean, var))
    return torch.from_numpy(canvas).to(cuda, torch.bfloat16), w_f, bias


@pytest.mark.parametrize("variant", ["conv", "pool", "dblbuf", "pipe"])
@pytest.mark.parametrize("shape", [(2, 64, 130), (1, 640, 640), (3, 30, 18)])
def test_probe_kernel_matches_plain(cuda, variant, shape):
    """Each probe kernel against its plain version: conv in the v4 class
    (only the f32 summation order differs) and, since it keeps the window
    centre of the values kernel A pools, relu(conv) <= full exactly; pool
    exactly (the same f32 adds in the same order); dblbuf and pipe in the v4
    class against their plain version and bit-identical to kernel A (dblbuf
    is A's code; pipe runs A's conv step and pool, split between warps)."""
    from dcfa_yolo_tpu_torch.ops import cuda_stem_probe as csp

    x, w_f, bias = _probe_inputs(cuda, *shape)
    before = _build.launches()
    out = csp.stem_probe(variant, x, w_f, bias)
    torch.cuda.synchronize()
    assert _build.launches(before)[f"stem_probe_{variant}"] == 1
    ref = csp.PLAIN[variant](x, w_f, bias)
    if variant == "pool":
        assert torch.equal(out, ref)
        return
    full = cuda_stem.stem_eval(x, w_f, bias)
    got, want = out.float().cpu().numpy(), ref.float().cpu().numpy()
    np.testing.assert_allclose(got, want, atol=0.03, rtol=0.02)
    assert (got == want).mean() >= 0.999
    if variant == "conv":
        assert bool((torch.relu(out.float()) <= full.float()).all())
    if variant in ("dblbuf", "pipe"):
        assert torch.equal(out, full)


@pytest.mark.parametrize("variant", ["pool", "pipe"])
@pytest.mark.parametrize("n_cta", [1, 7, 263])
def test_probe_kernel_any_grid(cuda, variant, n_cta):
    """pool and pipe on grids that divide nothing, through the C entry: up
    to 800 tiles a CTA at (1, 640, 640), a ragged last round of tiles, and
    for pipe both conv slots reused many times.  Bits as on the wrapper's
    grid: pool equal to pool_plain, pipe to kernel A."""
    from dcfa_yolo_tpu_torch.ops import _build
    from dcfa_yolo_tpu_torch.ops import cuda_stem_probe as csp

    x, w_f, bias = _probe_inputs(cuda, 1, 640, 640)
    want = csp.PLAIN["pool"](x, w_f, bias) if variant == "pool" else cuda_stem.stem_eval(
        x, w_f, bias)
    out = torch.full_like(want, float("nan"))
    lib = _build.load_library()
    rc = lib.stem_probe_bf16(_build.PROBE_CODES[variant], x.data_ptr(), w_f.data_ptr(),
                             bias.data_ptr(), out.data_ptr(), 1, 640, 640, n_cta,
                             torch.cuda.current_stream(cuda).cuda_stream)
    _build.check(rc, f"stem_probe {variant}")
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_deploy_predictor_matches_train_graph(cuda):
    """The served deploy graph (RepGhost fused, shuffles folded, kernels
    pre-cast to bf16) against the train graph from the same weights at 640²
    bf16, per anchor, at the serving limits (PERF.md section 2)."""
    from dcfa_yolo_tpu_torch.infer.pipeline import predict
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor

    kw = dict(input_shape=(640, 640), compute_dtype="bfloat16", device=cuda)
    dep = YOLOPredictor(["obj"], deploy=True, fold_shuffle=True, cast_weights=True, **kw)
    base = YOLOPredictor(["obj"], **kw)
    assert dep.model.backbone_rgb.dark3_conv.conv.weight.dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    nir = rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    bd, sd, cd = predict(dep.model, rgb, nir)
    bb, sb, cb = predict(base.model, rgb, nir)
    assert torch.equal(cd, cb)
    assert (sd - sb).abs().max().item() <= 0.005
    assert (bd - bb).abs().max().item() * 640 <= 0.5


# ---------------------------------------------------------------------------
# the captured serving pipeline (infer/pipeline.py::detect_batch_graph)

_GRAPH_FIELDS = ("boxes", "scores", "classes", "valid", "n_candidates")


@pytest.fixture(scope="module")
def serving_models():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor

    kw = dict(input_shape=(640, 640), compute_dtype="bfloat16", device="cuda")
    return {"train": YOLOPredictor(["obj"], **kw).model,
            "deploy": YOLOPredictor(["obj"], deploy=True, fold_shuffle=True,
                                    cast_weights=True, **kw).model}


def _serve_pairs(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, 480, 640, 3), dtype=np.uint8),
            rng.integers(0, 256, (b, 480, 640, 3), dtype=np.uint8),
            np.tile([480.0, 640.0], (b, 1)).astype(np.float32))


@pytest.mark.parametrize("graph", ["train", "deploy"])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("topk", [1024, 8400])
@pytest.mark.parametrize("letterbox", [True, False])
def test_graph_replay_equals_eager(cuda, serving_models, graph, b, topk, letterbox):
    """Each replay of the captured pipeline is bit-equal to the eager call
    on every output field, for two different inputs through one graph; the
    key captures once; a result held across a later replay is unchanged;
    every replay counts kernel A twice and kernel B once."""
    from dcfa_yolo_tpu_torch.infer.pipeline import (detect_batch, detect_batch_graph,
                                                    graph_count)

    model = serving_models[graph]
    kw = dict(conf_thres=0.001, iou_thres=0.5, letterbox=letterbox, max_det=300,
              pre_nms_topk=topk, nms="kernel", stem="kernel")
    x1, x2 = _serve_pairs(b, 1), _serve_pairs(b, 2)
    eager1, eager2 = detect_batch(model, *x1, **kw), detect_batch(model, *x2, **kw)
    n0 = graph_count(model)
    held = detect_batch_graph(model, *x1, **kw)
    before = _build.launches()
    second = detect_batch_graph(model, *x2, **kw)
    torch.cuda.synchronize()
    assert _build.launches(before) == {"stem_eval": 2, "nms_suppress": 1}
    assert graph_count(model) == n0 + 1
    for got, want in ((held, eager1), (second, eager2)):
        for f in _GRAPH_FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert eager1.valid.any()


def test_heatmap_graph_equals_eager(cuda, serving_models):
    from dcfa_yolo_tpu_torch.infer.pipeline import heatmap_batch, heatmap_batch_graph

    model = serving_models["train"]
    rgb, nir, _ = _serve_pairs(2, 4)
    eager = heatmap_batch(model, rgb, nir)
    for _ in range(2):
        got = heatmap_batch_graph(model, rgb, nir)
        assert len(got) == 3 and all(torch.equal(a, e) for a, e in zip(got, eager))


def test_failed_capture_raises(cuda, serving_models, monkeypatch):
    """A capture that fails raises and keeps no graph: a host read inside
    the pipeline cannot be captured, and nothing falls back to the eager
    result.  The counters keep only the warm-up's launches."""
    from dcfa_yolo_tpu_torch.infer import pipeline

    model = serving_models["train"]
    orig = pipeline.correct_boxes_yxyx

    def host_read(boxes, *a, **kw):
        float(boxes.sum())  # a device-to-host read
        return orig(boxes, *a, **kw)

    monkeypatch.setattr(pipeline, "correct_boxes_yxyx", host_read)
    rgb, nir, hw = _serve_pairs(1, 5)
    kw = dict(conf_thres=0.25, iou_thres=0.45, nms="kernel", stem="kernel")
    n0 = pipeline.graph_count(model)
    before = _build.launches()
    with pytest.raises(RuntimeError):
        pipeline.detect_batch_graph(model, rgb, nir, hw, **kw)
    assert pipeline.graph_count(model) == n0
    assert _build.launches(before) == {"stem_eval": 2, "nms_suppress": 1}


# ---------------------------------------------------------------------------
# the reference's weights on the card (models/torch_import.py)

@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """The golden manifest's synthetic weights as the reference's `.pth`."""
    from pathlib import Path

    from dcfa_yolo_tpu_torch.utils import golden

    repo = Path(__file__).resolve().parent.parent
    sd = golden.synth_state_dict(
        golden.load_manifest(str(repo / "tests" / "goldens" / "manifest.json")), 0)
    path = tmp_path_factory.mktemp("reference") / "reference.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    with np.load(repo / "tests" / "goldens" / "model_fwd.npz") as z:
        goldens = {k: z[k] for k in z.files}
    return str(path), goldens


def test_reference_pth_meets_goldens(cuda, reference_pth):
    """The reference's `.pth` through `YOLOPredictor(model_path=...)` in
    float32 (TF32 off) against the reference's own outputs, at
    tests/test_model_parity.py's limits."""
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
    from dcfa_yolo_tpu_torch.utils.golden import golden_errors

    path, goldens = reference_pth
    pred = YOLOPredictor(["object"], input_shape=(640, 640), model_path=path,
                         compute_dtype="float32", device=cuda)
    errors = golden_errors(pred.model, goldens)
    assert len(errors) == 12 and all(v <= 1.0 for v in errors.values()), errors


def test_reference_pth_served_through_the_graph(cuda, reference_pth):
    """The same `.pth` served in bf16 through the captured graph at b1 and
    b8: 2 stem and 1 NMS launches a replay; per-anchor predictions against
    kernel A's plain version at the serving limits (scores 0.005, boxes
    0.5 px, classes equal), NMS kernel == plain on them."""
    from dcfa_yolo_tpu_torch.infer import pipeline
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
    from dcfa_yolo_tpu_torch.ops.nms import batched_nms

    pred = YOLOPredictor(["object"], input_shape=(640, 640), confidence=0.001,
                         nms_iou=0.5, compute_dtype="bfloat16",
                         model_path=reference_pth[0], device=cuda)
    rgb1, nir1, _ = _serve_pairs(1, 21)
    rgb8, nir8, _ = _serve_pairs(8, 22)
    pred.detect(rgb1[0], nir1[0])
    pred.detect_batch(rgb8, nir8)
    before = _build.launches()
    dets = [pred.detect(rgb1[0], nir1[0])] + pred.detect_batch(rgb8, nir8)
    torch.cuda.synchronize()
    assert _build.launches(before) == {"stem_eval": 4, "nms_suppress": 2}
    assert all(len(b) > 0 and np.isfinite(b).all() for b, _, _ in dets)
    bk, sk, ck = pipeline.predict(pred.model, rgb8, nir8, stem="kernel")
    kernel = pipeline.stem_eval
    pipeline.stem_eval = cuda_stem.stem_eval_plain
    try:
        bp, sp, cp = pipeline.predict(pred.model, rgb8, nir8, stem="kernel")
    finally:
        pipeline.stem_eval = kernel
    assert torch.equal(ck, cp)
    assert (sk - sp).abs().max().item() <= 0.005
    assert (bk - bp).abs().max().item() * 640 <= 0.5
    kw = dict(conf_thres=0.001, iou_thres=0.5, pre_nms_topk=1024, max_det=300)
    rk = batched_nms(bk, sk, ck, backend="kernel", **kw)
    rp = batched_nms(bk, sk, ck, backend="plain", **kw)
    assert all(torch.equal(getattr(rk, f), getattr(rp, f)) for f in _GRAPH_FIELDS)
    pred.release_graphs()


# ---------------------------------------------------------------------------
# the opt-in serving graphs and other input shapes (models/pairing.py,
# split_neck_concats, multi-scale)

@pytest.mark.parametrize("variant,input_shape", [
    ("pair", (640, 640)), ("split", (640, 640)), ("deploy_split", (640, 640)),
    ("train", (320, 320)), ("train", (320, 416)), ("train", (1280, 1280))])
def test_variant_graph_replay_equals_eager(cuda, variant, input_shape):
    """The paired graph, the split graph (with and without deploy) and the
    train graph at 320², 320×416 and 1280², bf16, captured: each replay is
    bit-equal to the eager call on every output field for two inputs
    through one graph, and counts kernel A twice and kernel B once (in the
    paired graph A runs on the two modality slices of its block-diagonal
    stem); the paired graph's heatmaps too."""
    from dcfa_yolo_tpu_torch.infer.pipeline import (detect_batch, detect_batch_graph,
                                                    graph_count, heatmap_batch,
                                                    heatmap_batch_graph, release_graphs)
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor

    graph = dict(pair=dict(fold_shuffle=True, pair_backbones=True),
                 split=dict(fold_shuffle=True, split_neck_concats=True),
                 deploy_split=dict(deploy=True, fold_shuffle=True,
                                   split_neck_concats=True, cast_weights=True),
                 train={})[variant]
    model = YOLOPredictor(["obj"], input_shape=input_shape, compute_dtype="bfloat16",
                          device=cuda, **graph).model
    kw = dict(conf_thres=0.001, iou_thres=0.5, max_det=300, pre_nms_topk=1024,
              nms="kernel", stem="kernel")
    x1, x2 = _serve_pairs(2, 31), _serve_pairs(2, 32)
    eager1, eager2 = detect_batch(model, *x1, **kw), detect_batch(model, *x2, **kw)
    held = detect_batch_graph(model, *x1, **kw)
    before = _build.launches()
    second = detect_batch_graph(model, *x2, **kw)
    torch.cuda.synchronize()
    assert _build.launches(before) == {"stem_eval": 2, "nms_suppress": 1}
    assert graph_count(model) == 1
    for got, want in ((held, eager1), (second, eager2)):
        for f in _GRAPH_FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert eager1.valid.any()
    if variant == "pair":
        maps = heatmap_batch_graph(model, *x1[:2])
        assert all(torch.equal(a, e) for a, e in zip(maps, heatmap_batch(model, *x1[:2])))
    release_graphs(model)


def test_remat_step_launches_kernel_c_in_the_recompute(cuda):
    """A float32 step at 64² with remat: kernel C launches 4 times (both
    stems, forward and recompute) against 2 without, and the step is
    `torch.equal` to the one without (deterministic cuDNN)."""
    import dataclasses

    from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
    from dcfa_yolo_tpu_torch.models.yolo import init_model
    from dcfa_yolo_tpu_torch.parallel.dryrun import dry_batch
    from dcfa_yolo_tpu_torch.train.trainer import Trainer

    cfg = ModelConfig(num_classes=1, phi="n", input_shape=(64, 64), train_stem_backend="kernel")
    out = []
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            tr = Trainer(init_model(dataclasses.replace(cfg, remat=remat), 0, cuda, train=True),
                         TrainConfig(max_boxes=4), device=cuda)
            b = tr.put_batch(*dry_batch(4, (64, 64)))
            before = _build.launches()
            lb, g = tr.step_with_grad(b, 1e-2)
            torch.cuda.synchronize()
            out.append((_build.launches(before)["stem_train"], lb.total, g,
                        tr.flat_state.flat_stats))
    finally:
        torch.backends.cudnn.deterministic = False
    (n0, l0, g0, s0), (n1, l1, g1, s1) = out
    assert (n0, n1) == (2, 4)
    assert torch.equal(l0, l1) and torch.equal(g0, g1) and torch.equal(s0, s1)


@pytest.mark.parametrize("rdt", [torch.float32, torch.bfloat16])
def test_device_aug_on_the_card_matches_the_cpu(cuda, rdt):
    """The augmentation program on the card against the same program on the
    CPU (float32: pixels within 2e-5; bf16 on the card against bf16 operands
    in a float32 GEMM on the CPU: mean within 0.01 of a uint8 step), boxes,
    labels and masks equal."""
    from dcfa_yolo_tpu_torch.data import device_aug as da
    from dcfa_yolo_tpu_torch.tools.bench_device_aug import random_staged

    ds = random_staged(8, 96, max_boxes=8)
    smp = da.ParamSampler(ds, (128, 112), mosaic_prob=1.0, mixup_prob=0.5, epoch_length=10)
    smp.set_epoch(0)
    p = smp.sample(np.random.Generator(np.random.PCG64(1)), np.arange(4))
    prog = da.make_device_augment((128, 112), 8, resample_dtype=rdt)

    def call(device):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return [x.float().cpu() for x in prog(t(ds.images), t(ds.boxes), t(ds.nbox), t(p.idx),
                                              da.GeomParams(*(t(x) for x in p)))]

    card, cpu = call(cuda), call("cpu")
    for a, b in zip(card[2:], cpu[2:]):
        assert torch.equal(a, b)
    d = torch.cat([(a - b).abs() for a, b in zip(card[:2], cpu[:2])])
    if rdt == torch.float32:
        assert float(d.max()) <= 2e-5
    else:
        assert float(d.mean()) * 255 <= 0.01
