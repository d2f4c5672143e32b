"""Port serving pipeline (dcfa_yolo_tpu_torch/infer/pipeline.py) vs the JAX
`detect_batch`, on the CPU: letterbox, the float32 pipeline, and the bf16
kernel-path stem (its plain version on the CPU) against the JAX Pallas v4
stem in interpret mode.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfa_yolo_tpu.config import ModelConfig as JaxModelConfig
from dcfa_yolo_tpu.infer.pipeline import detect_batch as jax_detect_batch
from dcfa_yolo_tpu.models.torch_import import import_state_dict
from dcfa_yolo_tpu.models.yolo import DCFAYolo as JaxDCFAYolo
from dcfa_yolo_tpu.ops.resize import (letterbox_batch as jax_letterbox,
                                      letterbox_batch_cf as jax_letterbox_cf)
from dcfa_yolo_tpu.utils.golden import synth_state_dict
from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.infer.pipeline import detect_batch, resolve_stem
from dcfa_yolo_tpu_torch.models.yolo import init_model
from dcfa_yolo_tpu_torch.ops import _build
from dcfa_yolo_tpu_torch.ops.resize import letterbox_batch, letterbox_batch_cf

torch.set_num_threads(1)


def _pairs(seed, b, hw):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8),
            rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8))


def _to_flax(sd):
    """Port state_dict → flax variables tree (the carrier's inverse)."""
    tree = {"params": {}, "batch_stats": {}}
    for key, v in sd.items():
        *scopes, leaf = key.split(".")
        v = v.numpy()
        if leaf == "weight" and v.ndim == 4:
            coll, leaf, v = "params", "kernel", v.transpose(2, 3, 1, 0)
        elif leaf == "weight":
            coll, leaf = "params", "scale"
        elif leaf in ("running_mean", "running_var"):
            coll, leaf = "batch_stats", leaf[len("running_"):]
        else:
            coll = "params"
        node = tree[coll]
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _assert_detections_agree(ref, out, box_atol, score_atol):
    """The detection-agreement criterion of tests/test_pallas_stem.py:300-307."""
    np.testing.assert_array_equal(out.classes.numpy(), np.asarray(ref.classes))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(out.boxes.numpy(), np.asarray(ref.boxes),
                               atol=box_atol)
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               atol=score_atol)


def _check_letterbox(mine, ref):
    """At most 1 uint8 LSB off, on at most 1e-4 of pixels: the documented
    PIL-round tie class (a different f32 summation order can land the
    first pass on the other side of a .5 tie)."""
    d = np.abs(mine - ref)
    assert d.max() <= 1.0
    assert (d > 0).mean() <= 1e-4, (d > 0).mean()


@pytest.mark.parametrize("in_hw,out_hw", [((96, 120), (128, 128)),
                                          ((48, 72), (64, 64)),
                                          ((64, 64), (64, 64))])
def test_letterbox_matches_jax(in_hw, out_hw):
    rgb, _ = _pairs(3, 2, in_hw)
    _check_letterbox(letterbox_batch(torch.from_numpy(rgb), out_hw).numpy(),
                     np.asarray(jax_letterbox(jnp.asarray(rgb), out_hw)))
    cf = letterbox_batch_cf(torch.from_numpy(rgb), out_hw).numpy()
    assert cf.shape == (2, 3, out_hw[0] + 2, out_hw[1] + 2)
    _check_letterbox(cf, np.asarray(jax_letterbox_cf(jnp.asarray(rgb), out_hw)))


def test_detect_batch_f32_matches_jax(manifest):
    """float32 end to end at 128² on 96×120 pairs (letterboxed), reference
    synthetic weights: classes, valid and n_candidates equal, boxes within
    1e-3 px (float32 summation order only)."""
    hw = (128, 128)
    jmodel = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi="n", input_shape=hw))
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    template = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), dummy, dummy, train=False))
    variables, _ = import_state_dict(synth_state_dict(manifest, seed=0),
                                     template, strict=True)
    rgb, nir = _pairs(5, 2, (96, 120))
    image_hw = np.tile([96.0, 120.0], (2, 1)).astype(np.float32)
    kw = dict(conf_thres=0.3, iou_thres=0.5, max_det=50, pre_nms_topk=128)
    ref = jax.jit(lambda r, n, h: jax_detect_batch(
        jmodel, variables, r, n, h, stem_backend="xla", nms_backend="xla", **kw))(
        jnp.asarray(rgb), jnp.asarray(nir), jnp.asarray(image_hw))

    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
    pred = YOLOPredictor(["obj"], input_shape=hw, variables=variables,
                         device="cpu")
    out = detect_batch(pred.model, rgb, nir, image_hw, **kw)
    np.testing.assert_array_equal(out.n_candidates.numpy(),
                                  np.asarray(ref.n_candidates))
    assert out.valid.any()
    _assert_detections_agree(ref, out, box_atol=1e-3, score_atol=1e-5)


def test_detect_batch_bf16_kernel_stem_matches_jax_pallas_e():
    """bf16 at 64², nc=2: the port's kernel path (its plain versions on the
    CPU) vs JAX stem_backend='pallas_e' (interpret mode) and XLA NMS.

    The detection-agreement criterion is applied stage by stage, because
    with these lively random weights the greedy result is chaotic in bf16:
    neighbouring anchors predict the same ±260 px box with scores tied
    within ~3e-5, and JAX's own pallas_e and xla stems already differ by
    0.012 px on these boxes.  Measured here: the stem outputs are
    bit-equal, and the end-to-end results agree in classes and valid with
    boxes within 0.03 px, except one slot per image where greedy NMS picks
    the adjacent anchor of a tie.  So:
      * the fused stem outputs: the v4 class (≥99.9% bit-equal);
      * per-anchor predictions: classes equal, scores within 0.005 (the
        criterion's), boxes within 1e-3 of the input size (measured 4.1e-4;
        bf16 rounds at other places in the two frameworks: XLA fuses
        conv+BN+SiLU and rounds once, PyTorch rounds after each op);
      * NMS and the box unmapping on JAX's own predictions: exact.
    """
    from dcfa_yolo_tpu.infer.decode import (correct_boxes_yxyx as jax_correct,
                                            decode_box as jax_decode)
    from dcfa_yolo_tpu.infer.pipeline import _pallas_stem_outs
    from dcfa_yolo_tpu.ops.nms import batched_nms as jax_nms
    from dcfa_yolo_tpu_torch.infer.decode import correct_boxes_yxyx
    from dcfa_yolo_tpu_torch.infer.pipeline import _kernel_stem_outs, predict
    from dcfa_yolo_tpu_torch.ops.nms import batched_nms

    hw = (64, 64)
    cfg = ModelConfig(num_classes=2, phi="n", input_shape=hw,
                      compute_dtype="bfloat16")
    model = init_model(cfg, seed=0, device="cpu")
    jmodel = JaxDCFAYolo(JaxModelConfig(num_classes=2, phi="n", input_shape=hw,
                                        compute_dtype="bfloat16"))
    variables = _to_flax(model.state_dict())
    rgb, nir = _pairs(7, 2, (48, 72))
    image_hw = np.tile([48.0, 72.0], (2, 1)).astype(np.float32)

    def jax_front(r, n):
        so = _pallas_stem_outs(variables, r, n, hw, True, interpret=True,
                               variant="pallas_e")
        dummy = jnp.zeros((2, 2, 2, 3), jnp.float32)
        out = jmodel.apply(variables, dummy, dummy, train=False, stem_outs=so)
        pred = jax_decode(out.dbox, out.cls, out.anchors, out.strides, hw)
        xywh, s = pred[..., :4], pred[..., 4:]
        boxes = jnp.concatenate([xywh[..., :2] - xywh[..., 2:4] / 2,
                                 xywh[..., :2] + xywh[..., 2:4] / 2], -1)
        return so, boxes, jnp.max(s, -1), jnp.argmax(s, -1).astype(jnp.int32)

    so, jb, js, jc = jax.jit(jax_front)(jnp.asarray(rgb), jnp.asarray(nir))
    before = _build.launches()
    with torch.inference_mode():
        pso = _kernel_stem_outs(model, torch.from_numpy(rgb), torch.from_numpy(nir))
    for ref, mine in zip(so, pso):
        ref, mine = np.asarray(ref, np.float32), mine.float().numpy()
        np.testing.assert_allclose(mine, ref, atol=0.03, rtol=0.02)
        assert (mine == ref).mean() >= 0.999
    boxes, scores, classes = predict(model, rgb, nir, stem="kernel")
    np.testing.assert_array_equal(classes.numpy(), np.asarray(jc))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=0.005)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jb), atol=1e-3)

    kw = dict(conf_thres=0.3, iou_thres=0.5, max_det=10, pre_nms_topk=32)
    ref = jax_nms(jb, js, jc, backend="xla", **kw)
    out = batched_nms(*(torch.from_numpy(np.array(t)) for t in (jb, js, jc)),
                      backend="kernel", **kw)
    for name in ("boxes", "scores", "classes", "valid", "n_candidates"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert out.valid.any()
    np.testing.assert_allclose(
        correct_boxes_yxyx(out.boxes, hw, torch.from_numpy(image_hw)).numpy(),
        np.asarray(jax_correct(ref.boxes, hw, jnp.asarray(image_hw))),
        atol=1e-4)
    assert not _build.launches(before)


def test_resolve_stem(monkeypatch):
    """'auto' picks kernel A on an sm_90 card wherever the model fits it;
    on another card it keeps the plain graph and an explicit kernel request
    raises, naming sm_90.  On the CPU an explicit request runs the kernel's
    plain version."""
    ok = ModelConfig(num_classes=1, phi="n", compute_dtype="bfloat16")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (9, 0))
    assert resolve_stem("auto", ok, cuda) == "kernel"
    assert resolve_stem("auto", ok, cpu) == "plain"
    for name in ("kernel", "pallas", "pallas_d", "pallas_e", "pallas_f"):
        assert resolve_stem(name, ok, cpu) == "kernel"
        assert resolve_stem(name, ok, cuda) == "kernel"
    assert resolve_stem("xla", ok, cuda) == "plain"
    for bad in (ModelConfig(num_classes=1, phi="s", compute_dtype="bfloat16"),
                ModelConfig(num_classes=1, phi="n"),
                ModelConfig(num_classes=1, phi="n", input_shape=(642, 641),
                            compute_dtype="bfloat16")):
        assert resolve_stem("auto", bad, cuda) == "plain"
        with pytest.raises(ValueError):
            resolve_stem("kernel", bad, cuda)
    with pytest.raises(ValueError):
        resolve_stem("fast", ok, cuda)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (8, 0))
    assert resolve_stem("auto", ok, cuda) == "plain"
    assert resolve_stem("xla", ok, cuda) == "plain"
    assert resolve_stem("kernel", ok, cpu) == "kernel"
    for name in ("kernel", "pallas_e"):
        with pytest.raises(ValueError, match="sm_90"):
            resolve_stem(name, ok, cuda)
