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

from dcfa_yolo_tpu_torch.ops import cuda_nms, cuda_stem

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
