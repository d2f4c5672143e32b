"""The port's training criterion (dcfa_yolo_tpu_torch/ops/boxes.py,
train/assigner.py, train/loss.py) against the PyTorch reference goldens
(tests/goldens/train.npz) and against the JAX package's criterion, float32
on the CPU.

Tolerances: the goldens with those of tests/test_train.py (target scores
rtol 1e-4, losses rtol 2e-4; fg may differ from torch's only on zero-weight
candidates, whose top-k order torch leaves undefined).  Against the JAX
package the assignment must be identical (same top-k ties, lowest index
first), values and gradients within float32 summation-order noise (rtol
1e-5 / 1e-4).
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfa_yolo_tpu.config import ModelConfig as JaxModelConfig
from dcfa_yolo_tpu.config import TrainConfig as JaxTrainConfig
from dcfa_yolo_tpu.ops.boxes import bbox2dist as jax_bbox2dist
from dcfa_yolo_tpu.ops.boxes import bbox_iou as jax_bbox_iou
from dcfa_yolo_tpu.ops.boxes import xywh2xyxy as jax_xywh2xyxy
from dcfa_yolo_tpu.train.assigner import TaskAlignedAssigner as JaxAssigner
from dcfa_yolo_tpu.train.loss import YoloLoss as JaxYoloLoss
from dcfa_yolo_tpu.train.loss import pad_targets as jax_pad_targets
from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
from dcfa_yolo_tpu_torch.ops.boxes import bbox2dist, bbox_iou, xywh2xyxy
from dcfa_yolo_tpu_torch.train.assigner import (TaskAlignedAssigner,
                                                iterative_topk_indices)
from dcfa_yolo_tpu_torch.train.loss import YoloLoss, pad_targets

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "goldens" / "train.npz"
T = torch.from_numpy


@pytest.fixture(scope="module")
def tr():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _boxes(rng, n, xywh):
    xy = rng.uniform(0, 50, (n, 2))
    wh = rng.uniform(0.5, 30, (n, 2))
    b = np.concatenate([xy, wh] if xywh else [xy, xy + wh], -1)
    return b.astype(np.float32)


@pytest.mark.parametrize("kind", ["IoU", "GIoU", "DIoU", "CIoU"])
@pytest.mark.parametrize("xywh", [True, False])
def test_bbox_iou_matches_jax(kind, xywh):
    rng = np.random.default_rng(3)
    b1, b2 = _boxes(rng, 64, xywh), _boxes(rng, 64, xywh)
    flags = {k: k == kind for k in ("GIoU", "DIoU", "CIoU")}
    ref = jax_bbox_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=xywh, **flags)
    t1 = T(b1).requires_grad_(True)
    got = bbox_iou(t1, T(b2), xywh=xywh, **flags)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    # the gradient (CIoU's α carries none on either side)
    g_j = jax.grad(lambda a: jax_bbox_iou(a, jnp.asarray(b2), xywh=xywh,
                                          **flags).sum())(jnp.asarray(b1))
    got.sum().backward()
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-5)


def test_box_transforms_match_jax():
    rng = np.random.default_rng(4)
    box = _boxes(rng, 32, False)
    anc = rng.uniform(0, 50, (32, 2)).astype(np.float32)
    np.testing.assert_allclose(bbox2dist(T(anc), T(box), 15.0).numpy(),
                               np.asarray(jax_bbox2dist(jnp.asarray(anc),
                                                        jnp.asarray(box), 15.0)))
    np.testing.assert_allclose(xywh2xyxy(T(box)).numpy(),
                               np.asarray(jax_xywh2xyxy(jnp.asarray(box))))


def test_topk_takes_the_lowest_index_among_ties():
    x = torch.tensor([[0.0, 0.0, 0.5, 0.0, 0.5, 0.0, 0.0]])
    assert iterative_topk_indices(x, 4).tolist() == [[2, 4, 0, 1]]
    assert iterative_topk_indices(torch.zeros(2, 3, 9), 3).tolist() == [[[0, 1, 2]] * 3] * 2


def test_assigner_matches_reference_golden(tr):
    res = TaskAlignedAssigner(topk=10, num_classes=3, alpha=0.5, beta=6.0)(
        *(T(tr[k]) for k in ("as_pd_scores", "as_pd_bboxes", "as_anc",
                             "as_gt_labels", "as_gt_bboxes", "as_mask_gt")))
    np.testing.assert_allclose(res.target_scores.numpy(), tr["as_t_scores"],
                               rtol=1e-4, atol=1e-6)
    mine_fg, ref_fg = res.fg_mask.numpy(), tr["as_fg"].astype(bool)
    disagree = mine_fg != ref_fg
    if disagree.any():  # only on zero-weight candidates
        assert np.abs(tr["as_t_scores"].sum(-1)[disagree]).max() < 1e-6
        assert np.abs(res.target_scores.numpy().sum(-1)[disagree]).max() < 1e-6
    fg = ref_fg & mine_fg
    np.testing.assert_allclose(res.target_bboxes.numpy()[fg], tr["as_t_bboxes"][fg],
                               rtol=1e-5, atol=1e-4)


def _tie_case():
    """Two images, 5 gt rows (2 padded), 120 anchors; most anchors lie
    outside every gt box, so most alignment metrics are exactly 0, and the
    scores carry repeated values."""
    rng = np.random.default_rng(11)
    a, nc = 120, 3
    anc = np.stack(np.meshgrid(np.arange(12) * 8 + 4, np.arange(10) * 8 + 4),
                   -1).reshape(-1, 2).astype(np.float32)
    scores = np.round(rng.random((2, a, nc)) * 4) / 4
    scores = scores.astype(np.float32)
    ctr = anc[rng.integers(0, a, (2, a))] + rng.normal(0, 2, (2, a, 2))
    wh = rng.uniform(4, 20, (2, a, 2))
    pd = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    gt = np.array([[[2, 2, 30, 26], [40, 10, 70, 44], [5, 50, 20, 78],
                    [0, 0, 0, 0], [0, 0, 0, 0]],
                   [[60, 30, 90, 70], [10, 10, 12, 12], [0, 0, 0, 0],
                    [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    labels = np.array([[0, 2, 1, 0, 0], [1, 0, 0, 0, 0]], np.float32)[..., None]
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 0, 0, 0]], np.float32)[..., None]
    return scores, pd, anc, labels, gt, mask


def test_assigner_matches_jax_on_ties():
    args = _tie_case()
    ref = JaxAssigner(topk=10, num_classes=3)(*(jnp.asarray(a) for a in args))
    got = TaskAlignedAssigner(topk=10, num_classes=3)(*(T(a) for a in args))
    scores = got.target_scores.numpy()
    assert (scores == 0).mean() > 0.5  # the tie-heavy regime
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(ref.fg_mask))
    np.testing.assert_array_equal(got.target_gt_idx.numpy(),
                                  np.asarray(ref.target_gt_idx))
    np.testing.assert_array_equal(got.target_labels.numpy(),
                                  np.asarray(ref.target_labels))
    np.testing.assert_array_equal(got.target_bboxes.numpy(),
                                  np.asarray(ref.target_bboxes))
    np.testing.assert_allclose(scores, np.asarray(ref.target_scores), rtol=1e-5,
                               atol=1e-7)


def _criteria():
    cfg = dict(num_classes=3, phi="n", input_shape=(128, 128))
    return (YoloLoss(ModelConfig(**cfg), TrainConfig(max_boxes=8)),
            JaxYoloLoss(JaxModelConfig(**cfg), JaxTrainConfig(max_boxes=8)))


def _feats(tr):
    return [np.ascontiguousarray(tr[k].transpose(0, 2, 3, 1))
            for k in ("loss_feat_p3", "loss_feat_p4", "loss_feat_p5")]


@pytest.mark.parametrize("golden,targets", [("loss_total", "loss_targets"),
                                            ("loss_total_empty", None)])
def test_loss_matches_reference_golden(tr, golden, targets):
    labels = tr[targets] if targets else np.zeros((0, 6), np.float32)
    gt = pad_targets(labels, 2, 8, (128, 128))
    lb = _criteria()[0]([T(f) for f in _feats(tr)], *(T(g) for g in gt))
    np.testing.assert_allclose(float(lb.total), float(tr[golden]), rtol=2e-4)


def test_pad_targets_matches_jax(tr):
    labels = np.concatenate([tr["loss_targets"], tr["loss_targets"][:3] * [1, 1, 1, 1, 0.5, 0.5]])
    for got, ref in zip(pad_targets(labels, 2, 4, (128, 96)),
                        jax_pad_targets(labels, 2, 4, (128, 96))):
        np.testing.assert_array_equal(got, ref)


def test_loss_terms_and_gradients_match_jax(tr):
    port, ref = _criteria()
    feats = _feats(tr)
    gt = pad_targets(tr["loss_targets"], 2, 8, (128, 128))

    def jtotal(fs):
        lb = ref(fs, *(jnp.asarray(g) for g in gt))
        return lb.total, lb

    (_, lb_j), g_j = jax.value_and_grad(jtotal, has_aux=True)(
        [jnp.asarray(f) for f in feats])
    ft = [T(f).requires_grad_(True) for f in feats]
    lb = port(ft, *(T(g) for g in gt))
    for name in ("total", "box", "cls", "dfl"):
        np.testing.assert_allclose(float(getattr(lb, name)),
                                   float(getattr(lb_j, name)), rtol=1e-5, err_msg=name)
    lb.total.backward()
    for got, want in zip(ft, g_j):
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
