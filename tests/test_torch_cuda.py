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

from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem, cuda_stem_train

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(2, 64, 130), (1, 640, 640), (3, 30, 18)])
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
    before = cuda_stem.LAUNCHES
    out = cuda_stem.stem_eval(x, w_f, bias)
    torch.cuda.synchronize()
    assert cuda_stem.LAUNCHES == before + 1
    ref = cuda_stem.stem_eval_plain(x, w_f, bias)
    out, ref = out.float().cpu().numpy(), ref.float().cpu().numpy()
    np.testing.assert_allclose(out, ref, atol=0.03, rtol=0.02)
    assert (out == ref).mean() >= 0.999


def _boxes(rng, b, k):
    cxy = rng.uniform(20, 80, (b, 4, 2))[np.arange(b)[:, None], rng.integers(0, 4, (b, k))]
    cxy = cxy + rng.normal(0, 3, (b, k, 2))
    wh = rng.uniform(8, 24, (b, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    boxes[:, 0:k - 1:7] = [0, 0, 8, 4]     # IoU exactly 0.5 with the next box
    boxes[:, 1:k:7] = [0, 0, 4, 4]
    return boxes


@pytest.mark.parametrize("b,k", [(1, 1024), (8, 300), (9, 1024)])
def test_nms_kernel_matches_plain_exactly(cuda, b, k):
    rng = np.random.default_rng(b * k)
    boxes = torch.from_numpy(_boxes(rng, b, k)).to(cuda)
    alive = torch.from_numpy(rng.random((b, k)) < 0.8).to(cuda)
    alive[-1] = False  # an all-dead image
    for thr in (0.5, 0.3):
        before = cuda_nms.LAUNCHES
        keep = cuda_nms.greedy_suppress(boxes, alive, thr)
        torch.cuda.synchronize()
        assert cuda_nms.LAUNCHES == before + 1
        ref = cuda_nms.greedy_suppress_plain(boxes, alive, thr)
        assert torch.equal(keep, ref)
        assert not keep[-1].any()


@pytest.mark.parametrize("shape", [(2, 64, 130), (16, 640, 640), (3, 30, 18)])
def test_train_stem_kernel_matches_plain(cuda, shape):
    """Kernel C against stem_train_plain: pools in the v4 class (only the
    conv's f32 summation order differs), per-channel sums to 1e-3 relative
    (f32 sums in another order)."""
    b, h, w = shape
    rng = np.random.default_rng(h + w)
    x = torch.from_numpy(rng.random((b, h, w, 3), np.float32)).to(cuda, torch.bfloat16)
    k = torch.from_numpy((rng.standard_normal((16, 3, 3, 3)) * 0.3).astype(np.float32))
    k = k.to(cuda, torch.bfloat16)
    before = cuda_stem_train.LAUNCHES
    pmax, pmin, sums = cuda_stem_train.stem_train(x, k)
    torch.cuda.synchronize()
    assert cuda_stem_train.LAUNCHES == before + 1
    rmax, rmin, rsums = cuda_stem_train.stem_train_plain(x, k)
    for got, ref in ((pmax, rmax), (pmin, rmin)):
        got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
        np.testing.assert_allclose(got, ref, atol=0.03, rtol=0.02)
        assert (got == ref).mean() >= 0.999
    np.testing.assert_allclose(sums.cpu().numpy(), rsums.cpu().numpy(), rtol=1e-3,
                               atol=1e-3 * rsums.abs().max().item())


@pytest.mark.parametrize("shape", [(2, 64, 130), (16, 640, 640), (3, 30, 18)])
def test_train_stem_f32_kernel_matches_plain(cuda, shape):
    """Kernel C's float32 instantiation against stem_train_plain: only the
    conv's f32 summation order differs, so the pools agree within 1e-5 of
    max|ĉ| plus 1e-5 relative and the sums within 1e-4 relative; the launch
    is counted in LAUNCHES and LAUNCHES_F32."""
    b, h, w = shape
    rng = np.random.default_rng(h * w + 1)
    x = torch.from_numpy(rng.random((b, h, w, 3), np.float32)).to(cuda)
    k = torch.from_numpy((rng.standard_normal((16, 3, 3, 3)) * 0.3).astype(np.float32)).to(cuda)
    before = (cuda_stem_train.LAUNCHES, cuda_stem_train.LAUNCHES_F32)
    pmax, pmin, sums = cuda_stem_train.stem_train(x, k)
    torch.cuda.synchronize()
    assert (cuda_stem_train.LAUNCHES, cuda_stem_train.LAUNCHES_F32) == (
        before[0] + 1, before[1] + 1)
    assert pmax.dtype == pmin.dtype == torch.float32
    rmax, rmin, rsums = cuda_stem_train.stem_train_plain(x, k)
    c_max = max(rmax.abs().max().item(), rmin.abs().max().item())
    for got, ref in ((pmax, rmax), (pmin, rmin)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5,
                                   atol=1e-5 * c_max)
    np.testing.assert_allclose(sums.cpu().numpy(), rsums.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * rsums.abs().max().item())


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
    (only the f32 summation order differs), pool exactly (the same f32 adds
    in the same order), dblbuf and pipe bit-identical to kernel A."""
    from dcfa_yolo_tpu_torch.ops import cuda_stem_probe as csp

    x, w_f, bias = _probe_inputs(cuda, *shape)
    before = csp.LAUNCHES[variant]
    out = csp.stem_probe(variant, x, w_f, bias)
    torch.cuda.synchronize()
    assert csp.LAUNCHES[variant] == before + 1
    ref = csp.PLAIN[variant](x, w_f, bias)
    if variant == "pool":
        assert torch.equal(out, ref)
    else:
        got, want = out.float().cpu().numpy(), ref.float().cpu().numpy()
        np.testing.assert_allclose(got, want, atol=0.03, rtol=0.02)
        assert (got == want).mean() >= 0.999
    if variant in ("dblbuf", "pipe"):
        assert torch.equal(out, cuda_stem.stem_eval(x, w_f, bias))


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
