"""Port NMS (dcfa_yolo_tpu_torch/ops/cuda_nms.py, ops/nms.py) vs the JAX
package: the Pallas suppression kernel in interpret mode, the XLA
`_greedy_suppress` loop, and `batched_nms(backend="xla")`.

All comparisons are EXACT: the keep decision is a strict `iou > thr` on
f32 values computed in the same expression order, so any difference is a
bug (boxes here include IoUs that land exactly on the threshold).  The
CUDA kernel is held against the same plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py); its two phases, in its bit
layout, are held here through their plain versions `suppress_mask_plain`
and `scan_keep_plain`.  The sm_90 gating of the `auto` resolvers is
checked with `torch.cuda.get_device_capability` monkeypatched.
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
from dcfa_yolo_tpu_torch.ops.nms import batched_nms, resolve_nms

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


@pytest.mark.parametrize("b", [1, 3, 9])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 300])
def test_mask_and_scan_plain_match_jax(b, k):
    """The kernel's two phases in plain PyTorch (its bit layout, its block
    walk) against the JAX XLA loop and the Pallas kernel in interpret mode,
    exactly; K on both sides of the 32-bit word edge.  The scan must not
    read the words the kernel leaves unwritten: filling them with noise
    changes nothing."""
    rng = np.random.default_rng(1000 * b + k)
    boxes = clustered_boxes(rng, b, k)
    alive = rng.random((b, k)) < 0.8
    if b > 1:
        alive[1] = False             # an all-dead image
    bt, at = torch.from_numpy(boxes), torch.from_numpy(alive)
    for thr in (0.3, 0.5):
        ref_xla = np.asarray(_xla_keep(jnp.asarray(boxes), jnp.asarray(alive), thr))
        ref_pallas = np.asarray(pallas_greedy_suppress(
            jnp.asarray(boxes), jnp.asarray(alive), thr, interpret=True)) & alive
        np.testing.assert_array_equal(ref_pallas, ref_xla)
        mask = cuda_nms.suppress_mask_plain(bt, at, thr)
        _, w, _ = cuda_nms.mask_layout(k)
        assert mask.shape == (b, k, w) and mask.dtype == torch.int32
        keep = cuda_nms.scan_keep_plain(mask, at).numpy()
        np.testing.assert_array_equal(keep, ref_xla)
        unread = ~cuda_nms.scan_reads(at)
        noisy = mask.clone()
        noisy[unread] = torch.from_numpy(
            rng.integers(-2 ** 31, 2 ** 31, mask.shape, dtype=np.int64)
            .astype(np.int32))[unread]
        np.testing.assert_array_equal(cuda_nms.scan_keep_plain(noisy, at).numpy(),
                                      ref_xla)


@pytest.mark.parametrize("k", [33, 100])
def test_mask_words_match_numpy_iou(k):
    """suppress_mask_plain's words bit by bit against a numpy upper-triangle
    `iou > thr` in the JAX expression order: bit t of word w of row i is
    column j = 32w + t, set only for i < j < K; padded words are 0."""
    b, thr = 2, 0.5
    rng = np.random.default_rng(k)
    boxes = clustered_boxes(rng, b, k)
    iou = np.asarray(jax.vmap(lambda x: pairwise_iou_xyxy(x, x))(jnp.asarray(boxes)))
    want = (iou > np.float32(thr)) & np.triu(np.ones((k, k), bool), 1)[None]
    mask = cuda_nms.suppress_mask_plain(torch.from_numpy(boxes),
                                        torch.ones((b, k), dtype=torch.bool), thr)
    words = mask.numpy().view(np.uint32)
    nw, w, kp = cuda_nms.mask_layout(k)
    assert (nw, w, kp) == (-(-k // 32), -(-k // 128) * 4, 32 * -(-k // 32))
    bits = (words[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    bits = bits.reshape(b, k, w * 32).astype(bool)
    np.testing.assert_array_equal(bits[..., :k], want)
    assert not bits[..., k:].any()
    assert want.any()


def test_batched_nms_plain_matches_jax_at_8400_anchors():
    """The eval setting that `get_map`'s auto-raise reaches: 8400 anchors a
    640² image, all above conf 0.001, at pre_nms_topk 2048 (the port once
    capped the kernel at K = 1024).  Scores are multiples of 1/64, so the
    order among ties is held too."""
    b, a = 2, 8400
    rng = np.random.default_rng(8400)
    boxes = clustered_boxes(rng, b, a, at_threshold=False) * 4
    scores = (rng.integers(1, 65, (b, a)) / 64.0).astype(np.float32)
    classes = rng.integers(0, 2, (b, a)).astype(np.int32)
    kw = dict(conf_thres=0.001, iou_thres=0.5, pre_nms_topk=2048, max_det=300)
    ref = jax.jit(lambda bx, s, c: jax_batched_nms(bx, s, c, backend="xla", **kw))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes))
    out = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      torch.from_numpy(classes), backend="plain", **kw)
    for name in ("boxes", "scores", "classes", "valid", "n_candidates"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert out.n_candidates.tolist() == [a, a] and out.valid.any()


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: reaches the device checks of
    a kernel wrapper, which must raise before anything touches the card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("cap,route", [((9, 0), "kernel"), ((8, 0), "plain"),
                                       ((9, 1), "plain")])
def test_nms_auto_needs_sm90(monkeypatch, cap, route):
    """'auto' takes kernel B only on an sm_90 card, the plain version on
    any other card and on the CPU; on another card an explicit kernel
    request raises in greedy_suppress, naming sm_90."""
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: cap)
    card = torch.device("cuda", 0)
    assert resolve_nms("auto", card) == route
    assert resolve_nms("auto", torch.device("cpu")) == "plain"
    assert resolve_nms("kernel", card) == "kernel"
    assert resolve_nms("plain", card) == "plain"
    with pytest.raises(ValueError):
        resolve_nms("pallas", card)
    if route == "plain":
        boxes = torch.zeros((1, 8, 4)).as_subclass(_OnCard)
        alive = torch.ones((1, 8), dtype=torch.bool).as_subclass(_OnCard)
        before = cuda_nms.LAUNCHES
        with pytest.raises(ValueError, match="sm_90"):
            cuda_nms.greedy_suppress(boxes, alive, 0.5)
        assert cuda_nms.LAUNCHES == before


def test_greedy_suppress_takes_any_k_on_the_cpu():
    """No K cap: the plain version takes K past the old kernel's 1024, and
    the layout grows with it (W words a row, rounded to 16 bytes)."""
    rng = np.random.default_rng(3)
    boxes = torch.from_numpy(clustered_boxes(rng, 1, 1500))
    alive = torch.ones((1, 1500), dtype=torch.bool)
    keep = cuda_nms.greedy_suppress(boxes, alive, 0.5)
    assert keep.shape == (1, 1500) and 0 < int(keep.sum()) < 1500
    assert cuda_nms.mask_layout(8400) == (263, 264, 8416)
    assert not hasattr(cuda_nms, "MAX_K")
