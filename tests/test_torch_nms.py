"""Port NMS (dcfa_yolo_tpu_torch/ops/cuda_nms.py, ops/nms.py) vs the JAX
package: the Pallas suppression kernel in interpret mode, the XLA
`_greedy_suppress` loop, and `batched_nms(backend="xla")`.

All comparisons are EXACT: the keep decision is a strict `iou > thr` on
f32 values computed in the same expression order, so any difference is a
bug (boxes here include IoUs that land exactly on the threshold).  The
CUDA kernel is held against the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfa_yolo_tpu.ops.nms import _greedy_suppress, batched_nms as jax_batched_nms
from dcfa_yolo_tpu.ops.boxes import pairwise_iou_xyxy
from dcfa_yolo_tpu.ops.pallas_nms import pallas_greedy_suppress
from dcfa_yolo_tpu_torch.ops import cuda_nms
from dcfa_yolo_tpu_torch.ops.nms import batched_nms

torch.set_num_threads(1)


def clustered_boxes(rng, b, k, at_threshold=True):
    """Score-sorted xyxy boxes in a few tight clusters (many IoUs near any
    threshold), with exact-threshold pairs: [x, y, x+2s, y+s] vs
    [x, y, x+s, y+s] has inter s², union 2s² (+1e-7 vanishes in f32), so
    IoU is exactly 0.5."""
    centers = rng.uniform(20, 80, (b, 4, 2))
    which = rng.integers(0, 4, (b, k))
    cxy = np.take_along_axis(centers, which[..., None].repeat(2, -1), 1)
    cxy = cxy + rng.normal(0, 3, (b, k, 2))
    wh = rng.uniform(8, 24, (b, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    if at_threshold:
        for i in range(b):
            for j in range(0, k - 1, 7):
                x, y, s = float(rng.integers(0, 64)), float(rng.integers(0, 64)), 4.0
                boxes[i, j] = [x, y, x + 2 * s, y + s]
                boxes[i, j + 1] = [x, y, x + s, y + s]
    return boxes


def _xla_keep(boxes, alive, thr):
    return jax.vmap(lambda bx, al: _greedy_suppress(
        pairwise_iou_xyxy(bx, bx), al, thr) & al)(boxes, alive)


@pytest.mark.parametrize("b", [1, 3, 9])
@pytest.mark.parametrize("k", [64, 300])
def test_greedy_suppress_plain_exact(b, k):
    rng = np.random.default_rng(100 * b + k)
    boxes = clustered_boxes(rng, b, k)
    alive = rng.random((b, k)) < 0.8
    alive[0, k // 2:] = False        # a ragged alive prefix
    if b > 1:
        alive[1] = False             # an all-dead image
    for thr in (0.5, 0.3):
        ref_pallas = np.asarray(pallas_greedy_suppress(
            jnp.asarray(boxes), jnp.asarray(alive), thr, interpret=True)) & alive
        ref_xla = np.asarray(_xla_keep(jnp.asarray(boxes), jnp.asarray(alive), thr))
        np.testing.assert_array_equal(ref_pallas, ref_xla)
        before = cuda_nms.LAUNCHES
        keep = cuda_nms.greedy_suppress(torch.from_numpy(boxes),
                                        torch.from_numpy(alive), thr).numpy()
        assert cuda_nms.LAUNCHES == before  # CPU tensors never launch
        np.testing.assert_array_equal(keep, ref_xla)


def test_at_threshold_pair_is_not_suppressed():
    boxes = np.array([[[0, 0, 8, 4], [0, 0, 4, 4], [0, 0, 4.5, 4]]], np.float32)
    alive = np.ones((1, 3), bool)
    keep = cuda_nms.greedy_suppress_plain(torch.from_numpy(boxes),
                                          torch.from_numpy(alive), 0.5).numpy()
    # IoU(0, 1) == 0.5 exactly: kept (strict >); IoU(0, 2) == 0.5625: dropped
    np.testing.assert_array_equal(keep, [[True, True, False]])


@pytest.mark.parametrize("a,topk,max_det", [(200, 64, 30), (20, 64, 30)])
def test_batched_nms_plain_matches_jax_xla(a, topk, max_det):
    """Deliberately equal scores (multiples of 1/32): the candidate order
    among ties, and with it the keep set, must follow jax.lax.top_k's
    lower-index-first order.  a=20 < max_det exercises the pad."""
    b = 3
    rng = np.random.default_rng(a)
    boxes = clustered_boxes(rng, b, a)
    scores = (rng.integers(0, 33, (b, a)) / 32.0).astype(np.float32)
    classes = rng.integers(0, 3, (b, a)).astype(np.int32)
    kw = dict(conf_thres=0.25, iou_thres=0.45, pre_nms_topk=topk, max_det=max_det)
    ref = jax.jit(lambda bx, s, c: jax_batched_nms(bx, s, c, backend="xla", **kw))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes))
    out = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      torch.from_numpy(classes), backend="plain", **kw)
    for name in ("boxes", "scores", "classes", "valid", "n_candidates"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert out.valid.any()


def test_greedy_suppress_rejects_bad_shapes():
    with pytest.raises(ValueError):
        cuda_nms.greedy_suppress(torch.zeros((1, 8, 3)), torch.ones((1, 8), dtype=torch.bool), 0.5)
    with pytest.raises(ValueError):
        batched_nms(torch.zeros((1, 8, 4)), torch.zeros((1, 8)),
                    torch.zeros((1, 8), dtype=torch.int32), 0.1, 0.5,
                    backend="pallas")
