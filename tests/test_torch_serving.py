"""The port's serving slice against the JAX package on the CPU: the bicubic
stretch, `correct_boxes_yxyx(letterbox=False)`, `detect_batch(letterbox=
False)` and the heatmaps, the per-call host constants, the `unflatten`
carrier, and `YOLOPredictor` (the cases of tests/test_predictor.py, from a
checkpoint path and a classes file, and one 640² case on trained weights).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from dcfa_yolo_tpu.config import ModelConfig as JaxModelConfig
from dcfa_yolo_tpu.infer.decode import correct_boxes_yxyx as jax_correct_boxes
from dcfa_yolo_tpu.infer.decode import decode_box as jax_decode_box
from dcfa_yolo_tpu.infer.pipeline import detect_batch as jax_detect_batch
from dcfa_yolo_tpu.infer.pipeline import heatmap_batch_jit as jax_heatmap_batch
from dcfa_yolo_tpu.infer.pipeline import heatmap_scores as jax_heatmap_scores
from dcfa_yolo_tpu.models.torch_import import import_state_dict
from dcfa_yolo_tpu.models.yolo import DCFAYolo as JaxDCFAYolo
from dcfa_yolo_tpu.ops.resize import resize_bicubic as jax_resize_bicubic
from dcfa_yolo_tpu.utils.golden import synth_state_dict
from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.infer import pipeline
from dcfa_yolo_tpu_torch.infer.decode import correct_boxes_yxyx, decode_box
from dcfa_yolo_tpu_torch.infer.pipeline import (detect_batch, detect_batch_graph,
                                                heatmap_batch, heatmap_batch_graph,
                                                heatmap_scores)
from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
from dcfa_yolo_tpu_torch.models.convert import load_flat_npz, unflatten
from dcfa_yolo_tpu_torch.models.yolo import init_model
from dcfa_yolo_tpu_torch.ops import consts
from dcfa_yolo_tpu_torch.ops.resize import letterbox_batch, resize_bicubic
from dcfa_yolo_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "ab_weights_f16.npz"


def _pairs(seed, b, hw):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8),
            rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8))


def _check_letterbox(mine, ref):
    """tests/test_torch_pipeline.py's letterbox tolerance: at most 1 uint8
    LSB off, on at most 1e-4 of pixels (PIL-round ties)."""
    d = np.abs(mine - ref)
    assert d.max() <= 1.0
    assert (d > 0).mean() <= 1e-4, (d > 0).mean()


def _jax_variables(manifest, hw):
    jmodel = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi="n", input_shape=hw))
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    template = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), dummy, dummy, train=False))
    variables, _ = import_state_dict(synth_state_dict(manifest, seed=0),
                                     template, strict=True)
    return jmodel, variables


# --- resize, unmapping, goldens ----------------------------------------------

@pytest.mark.parametrize("pil_parity", [True, False])
@pytest.mark.parametrize("in_hw,out_hw", [((96, 120), (64, 64)),    # down
                                          ((48, 72), (128, 96)),    # up
                                          ((48, 72), (64, 64))])    # up / down
def test_resize_bicubic_matches_jax(pil_parity, in_hw, out_hw):
    """Both flavours, up- and down-scaling, rounded to uint8 as the
    letterbox=False path rounds: the letterbox tolerance.  The plain cubic
    has no rounding between its passes, so its raw output is also held
    within 1e-3 (float32 summation order)."""
    rgb, _ = _pairs(11, 2, in_hw)
    mine = resize_bicubic(torch.from_numpy(rgb).float(), out_hw, pil_parity).numpy()
    ref = np.asarray(jax_resize_bicubic(jnp.asarray(rgb, jnp.float32), out_hw,
                                        pil_parity=pil_parity))
    assert mine.shape == ref.shape == (2, *out_hw, 3)
    _check_letterbox(np.clip(np.round(mine), 0, 255), np.clip(np.round(ref), 0, 255))
    if not pil_parity:
        np.testing.assert_allclose(mine, ref, atol=1e-3)


@pytest.mark.parametrize("letterbox,key", [(True, "cb_letterbox"), (False, "cb_plain")])
def test_correct_boxes_matches_jax_and_goldens(golden_ops, letterbox, key):
    """The reference's `yolo_correct_boxes` goldens (tests/test_infer.py's
    tolerance) and the JAX function, batched and unbatched image_hw."""
    xy, wh = golden_ops["cb_xy"], golden_ops["cb_wh"]
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    out = correct_boxes_yxyx(torch.from_numpy(boxes), (640, 640),
                             torch.tensor([480.0, 602.0]), letterbox=letterbox)
    np.testing.assert_allclose(out.numpy(), golden_ops[key], rtol=1e-5, atol=1e-4)
    ref = jax_correct_boxes(jnp.asarray(boxes), (640, 640), np.array([480.0, 602.0]),
                            letterbox=letterbox)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)
    hw = np.array([[480.0, 602.0], [320.0, 200.0]], np.float32)
    batched = correct_boxes_yxyx(torch.from_numpy(np.stack([boxes, boxes])), (640, 640),
                                 torch.from_numpy(hw), letterbox=letterbox)
    ref = jax_correct_boxes(jnp.asarray(np.stack([boxes, boxes])), (640, 640),
                            jnp.asarray(hw), letterbox=letterbox)
    np.testing.assert_allclose(batched.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)


def test_letterbox_and_decode_match_goldens(golden_ops, golden_model_fwd):
    """The reference's PIL letterbox of a 480×602 image (tests/test_ops.py's
    tolerance against PIL's fixed-point passes; against the JAX letterbox,
    the letterbox tolerance) and its decode (tests/test_infer.py's)."""
    from dcfa_yolo_tpu.ops.resize import letterbox_batch as jax_letterbox

    img = golden_ops["letterbox_in"][None]
    out = letterbox_batch(torch.from_numpy(img), (640, 640))[0].numpy()
    diff = np.abs(out - golden_ops["letterbox_out"].astype(np.float32))
    assert float(np.mean(diff <= 1.0)) > 0.995 and float(diff.max()) <= 16.0
    _check_letterbox(out, np.asarray(jax_letterbox(jnp.asarray(img), (640, 640)))[0])
    z = golden_model_fwd
    y = decode_box(torch.from_numpy(np.ascontiguousarray(np.transpose(z["dbox"], (0, 2, 1)))),
                   torch.from_numpy(np.ascontiguousarray(np.transpose(z["cls"], (0, 2, 1)))),
                   torch.from_numpy(np.ascontiguousarray(z["anchors"].T)),
                   torch.from_numpy(np.ascontiguousarray(z["strides"].T)), (640, 640))
    np.testing.assert_allclose(y.numpy(), golden_ops["decoded_y"], rtol=1e-4, atol=1e-5)
    ref = jax_decode_box(*(jnp.asarray(np.transpose(z[k], (0, 2, 1))) for k in ("dbox", "cls")),
                         jnp.asarray(z["anchors"].T), jnp.asarray(z["strides"].T), (640, 640))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


# --- the pipeline --------------------------------------------------------------

@pytest.mark.parametrize("in_hw", [(48, 72), (64, 64)])
def test_detect_batch_stretch_matches_jax(manifest, in_hw):
    """float32 end to end at 64² with letterbox=False (a bicubic stretch,
    then the unmapping without the letterbox): the criterion of
    tests/test_torch_pipeline.py::test_detect_batch_f32_matches_jax.  An
    input already at 64² is used as it is."""
    hw = (64, 64)
    jmodel, variables = _jax_variables(manifest, hw)
    rgb, nir = _pairs(5, 2, in_hw)
    image_hw = np.tile(np.asarray(in_hw, np.float32), (2, 1))
    kw = dict(conf_thres=0.3, iou_thres=0.5, max_det=50, pre_nms_topk=128,
              letterbox=False)
    ref = jax.jit(lambda r, n, h: jax_detect_batch(
        jmodel, variables, r, n, h, stem_backend="xla", nms_backend="xla", **kw))(
        jnp.asarray(rgb), jnp.asarray(nir), jnp.asarray(image_hw))
    pred = YOLOPredictor(["obj"], input_shape=hw, variables=variables, device="cpu")
    out = detect_batch(pred.model, rgb, nir, image_hw, **kw)
    np.testing.assert_array_equal(out.n_candidates.numpy(), np.asarray(ref.n_candidates))
    np.testing.assert_array_equal(out.classes.numpy(), np.asarray(ref.classes))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert out.valid.any()
    np.testing.assert_allclose(out.boxes.numpy(), np.asarray(ref.boxes), atol=1e-3)
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), atol=1e-5)


def test_stretch_kernel_stem_canvas_matches_plain_input():
    """letterbox=False through the kernel stem: the kernel's canvas is the
    plain path's stretched input, channels first, in a 1-px zero border."""
    rgb, _ = _pairs(6, 2, (48, 72))
    x = torch.from_numpy(rgb)
    cf = pipeline._stem_canvas(x, (64, 64), letterbox=False)
    plain = pipeline._model_input(x, (64, 64), letterbox=False)
    assert cf.shape == (2, 3, 66, 66)
    assert torch.equal(cf[:, :, 1:-1, 1:-1], plain.permute(0, 3, 1, 2))
    assert not cf[:, :, 0].any() and not cf[:, :, -1].any()
    assert not cf[..., 0].any() and not cf[..., -1].any()


def test_heatmaps_match_jax(manifest):
    """heatmap_scores on the same normalized inputs and the raw-pair
    heatmap_batch against JAX, float32 at 64²: one (B, h, w) map per level."""
    hw = (64, 64)
    jmodel, variables = _jax_variables(manifest, hw)
    pred = YOLOPredictor(["obj"], input_shape=hw, variables=variables, device="cpu")
    rng = np.random.default_rng(8)
    r, n = (rng.random((2, 64, 64, 3), np.float32) for _ in range(2))
    with torch.inference_mode():
        mine = heatmap_scores(pred.model, torch.from_numpy(r), torch.from_numpy(n))
    ref = jax_heatmap_scores(jmodel, variables, jnp.asarray(r), jnp.asarray(n))
    assert [m.shape for m in mine] == [(2, 8, 8), (2, 4, 4), (2, 2, 2)]
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    rgb, nir = _pairs(9, 1, (48, 72))
    mine = heatmap_batch(pred.model, rgb, nir)
    ref = jax_heatmap_batch(jmodel, variables, jnp.asarray(rgb), jnp.asarray(nir))
    for a, b in zip(mine, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("stem,nms,letterbox", [("kernel", "kernel", True),
                                                ("plain", "plain", True),
                                                ("kernel", "plain", False),
                                                ("plain", "kernel", False)])
def test_second_call_builds_nothing_from_host_data(monkeypatch, stem, nms, letterbox):
    """Once a shape has been served, a call makes no tensor from host data
    but its inputs and no new device constant: nothing a CUDA graph could
    not capture (the wrappers take their plain versions here)."""
    model = init_model(ModelConfig(num_classes=2, phi="n", input_shape=(64, 64),
                                   compute_dtype="bfloat16"), 0, "cpu")
    rgb, nir = _pairs(2, 2, (48, 72))
    hw = np.tile([48.0, 72.0], (2, 1)).astype(np.float32)
    kw = dict(conf_thres=0.05, iou_thres=0.5, max_det=20, pre_nms_topk=64,
              letterbox=letterbox, stem=stem, nms=nms)
    detect_batch(model, rgb, nir, hw, **kw)
    heatmap_batch(model, rgb, nir)
    made = []

    def spy(name, fn, allowed=()):
        def wrapped(data, *a, **k):
            if not (isinstance(data, torch.Tensor) or any(data is x for x in allowed)):
                made.append(name)
            return fn(data, *a, **k)
        return wrapped

    n_consts = len(consts._CACHE)
    monkeypatch.setattr(torch, "tensor", spy("tensor", torch.tensor))
    monkeypatch.setattr(torch, "from_numpy", spy("from_numpy", torch.from_numpy))
    monkeypatch.setattr(torch, "as_tensor", spy("as_tensor", torch.as_tensor,
                                                (rgb, nir, hw)))
    out = detect_batch(model, rgb, nir, hw, **kw)
    heatmap_batch(model, rgb, nir)
    assert made == [] and len(consts._CACHE) == n_consts
    assert out.valid.any()


def test_graph_entry_points_raise_on_a_cpu_model():
    """The captured pipeline needs a CUDA model; on the CPU the explicit
    path is `detect_batch` / `heatmap_batch`."""
    model = init_model(ModelConfig(num_classes=1, input_shape=(64, 64)), 0, "cpu")
    rgb, nir = _pairs(3, 1, (48, 72))
    with pytest.raises(ValueError, match="CUDA device.*detect_batch"):
        detect_batch_graph(model, rgb, nir, [[48.0, 72.0]], conf_thres=0.5,
                           iou_thres=0.5)
    with pytest.raises(ValueError, match="CUDA device.*heatmap_batch"):
        heatmap_batch_graph(model, rgb, nir)


def test_unflatten_matches_the_fixture_tool():
    """The port's `unflatten` builds the tree tools/make_ab_fixture.py's
    does; the fixture loads strictly into the port's train graph."""
    from tools.make_ab_fixture import unflatten as tool_unflatten

    with np.load(FIXTURE) as z:
        flat = {k: z[k] for k in z.files}
    assert len(flat) == 475

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return a is b

    assert same(unflatten(flat), tool_unflatten(flat))
    tree = load_flat_npz(str(FIXTURE))
    assert set(tree) == {"params", "batch_stats"}
    YOLOPredictor(["tomato_bunch"], input_shape=(64, 64), variables=tree, device="cpu")


# --- YOLOPredictor -----------------------------------------------------------

def _save_port_checkpoint(path, model):
    sd = model.state_dict()
    buffers = {k for k, _ in model.named_buffers()}
    save_checkpoint(str(path), dict(
        params={k: v for k, v in sd.items() if k not in buffers},
        batch_stats={k: v for k, v in sd.items() if k in buffers},
        ema={}, opt_state={}, ema_updates=0, epoch=0))


@pytest.fixture(scope="module")
def ckpt_paths(tmp_path_factory):
    """A port checkpoint of `init_model(seed=0)` weights for 2 classes at
    64², and a classes file."""
    d = tmp_path_factory.mktemp("predictor")
    model = init_model(ModelConfig(num_classes=2, phi="n", input_shape=(64, 64)),
                       0, "cpu")
    _save_port_checkpoint(d / "w.ckpt", model)
    (d / "classes.txt").write_text("a\nb\n")
    return str(d / "w.ckpt"), str(d / "classes.txt")


@pytest.fixture(scope="module")
def predictor(ckpt_paths):
    return YOLOPredictor(model_path=ckpt_paths[0], classes_path=ckpt_paths[1],
                         input_shape=(64, 64), confidence=0.01, nms_iou=0.5,
                         max_det=20, device="cpu")


def _pil_pair(seed, size=(120, 96)):
    rng = np.random.Generator(np.random.PCG64(seed))
    return (Image.fromarray(rng.integers(0, 255, size + (3,), dtype=np.uint8)),
            Image.fromarray(rng.integers(0, 255, size + (3,), dtype=np.uint8)))


class TestPredictor:
    """tests/test_predictor.py's cases on the port, the predictor built from
    a checkpoint path and a classes file."""

    def test_loads_the_checkpoint(self, predictor, ckpt_paths):
        want = init_model(ModelConfig(num_classes=2, phi="n", input_shape=(64, 64)),
                          0, "cpu").state_dict()
        got = predictor.model.state_dict()
        assert predictor.class_names == ["a", "b"] and got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert len(predictor.colors) == 2 and predictor.colors[0] == (255, 0, 0)

    def test_detect_shapes(self, predictor):
        boxes, scores, classes = predictor.detect(*_pil_pair(0))
        assert boxes.ndim == 2 and boxes.shape[1] == 4
        assert len(boxes) == len(scores) == len(classes) > 0

    def test_detect_batch_consistent_with_single(self, predictor):
        rgb, nir = _pil_pair(1)
        single = predictor.detect(rgb, nir)
        batched = predictor.detect_batch([rgb, rgb], [nir, nir])
        assert len(batched) == 2
        np.testing.assert_allclose(batched[0][0], single[0], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(batched[1][1], single[1], rtol=1e-5)

    def test_deploy_predictor_matches_train_graph(self, predictor, ckpt_paths):
        dep = YOLOPredictor(model_path=ckpt_paths[0], classes_path=ckpt_paths[1],
                            input_shape=(64, 64), confidence=0.01, nms_iou=0.5,
                            max_det=20, deploy=True, fold_shuffle=True, device="cpu")
        assert dep.model.deploy and dep.model.fold_shuffle
        rgb, nir = _pil_pair(7)
        b0, s0, c0 = predictor.detect(rgb, nir)
        b1, s1, c1 = dep.detect(rgb, nir)
        assert len(b0) == len(b1)
        np.testing.assert_allclose(b1, b0, rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(s1, s0, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(c1, c0)

    def test_detect_heatmap_writes_file(self, predictor, tmp_path):
        out = str(tmp_path / "hm.png")
        predictor.detect_heatmap(*_pil_pair(8), out)
        assert os.path.exists(out) and os.path.getsize(out) > 0

    def test_detect_image_draws(self, predictor):
        rgb, nir = _pil_pair(2)
        before = np.asarray(rgb).copy()
        out = predictor.detect_image(rgb, nir)
        assert out.size == rgb.size and not np.array_equal(np.asarray(out), before)

    def test_grayscale_input_converted(self, predictor):
        rng = np.random.Generator(np.random.PCG64(3))
        gray = Image.fromarray(rng.integers(0, 255, (96, 120), dtype=np.uint8), mode="L")
        boxes, _, _ = predictor.detect(gray, gray)
        assert boxes.shape[1] == 4

    def test_get_map_txt_format(self, predictor, tmp_path):
        predictor.get_map_txt("img1", *_pil_pair(4), ["a", "b"], str(tmp_path))
        txt = (tmp_path / "detection-results" / "img1.txt").read_text()
        assert txt.strip()
        for line in txt.strip().splitlines():
            parts = line.split()
            assert parts[0] in ("a", "b")
            float(parts[1])
            [int(x) for x in parts[2:6]]

    def test_get_map_txt_batch_matches_per_image(self, predictor, tmp_path):
        pairs = [_pil_pair(s) for s in (11, 12, 13)]
        for i, (rgb, nir) in enumerate(pairs):
            predictor.get_map_txt(f"im{i}", rgb, nir, ["a", "b"], str(tmp_path / "one"))
        predictor.get_map_txt_batch([f"im{i}" for i in range(3)], [p[0] for p in pairs],
                                    [p[1] for p in pairs], ["a", "b"], str(tmp_path / "all"))
        for i in range(3):
            a = (tmp_path / "one" / "detection-results" / f"im{i}.txt").read_text()
            b = (tmp_path / "all" / "detection-results" / f"im{i}.txt").read_text()
            assert a == b, f"im{i} differs"


def test_predictor_constructor_contract(tmp_path, ckpt_paths):
    """Files that are no weights of this model raise: a `.npz` none of whose
    keys the reference model has, and a truncated msgpack file, which is
    none of the four formats; pair_backbones without fold_shuffle raises
    (JAX `predictor.py:94-95`), before any device is touched, while
    split_neck_concats builds the split graph from the checkpoint and
    serves; class names from neither argument raise."""
    np.savez(tmp_path / "w.npz", a=np.zeros(3))
    (tmp_path / "w.ckpt").write_bytes(b"\x81\xa6params")  # msgpack, cut short
    for path, match in ((tmp_path / "w.npz", "none of its 1 keys"),
                        (tmp_path / "w.ckpt", "none of the weight formats")):
        with pytest.raises(ValueError, match=match):
            YOLOPredictor(model_path=str(path), classes_path=ckpt_paths[1],
                          input_shape=(64, 64), device="cpu")
    with pytest.raises(ValueError, match="fold_shuffle=True"):
        YOLOPredictor(["a"], pair_backbones=True)
    split = YOLOPredictor(model_path=ckpt_paths[0], classes_path=ckpt_paths[1],
                          input_shape=(64, 64), confidence=0.01, split_neck_concats=True,
                          device="cpu")
    assert split.model.split_neck_concats and split.model.bi_fpn.return_parts
    boxes, scores, classes = split.detect(*_pil_pair(9))
    assert boxes.shape[1] == 4 and len(boxes) == len(scores) == len(classes) > 0
    with pytest.raises(ValueError, match="classes_path"):
        YOLOPredictor(input_shape=(64, 64), device="cpu")


def test_predictor_stretch_matches_jax(manifest):
    """letterbox_image=False through the facade, float32 at 64², against
    the JAX facade: the same detections."""
    from dcfa_yolo_tpu.infer.predictor import YOLOPredictor as JaxPredictor

    _, variables = _jax_variables(manifest, (64, 64))
    kw = dict(class_names=["obj"], input_shape=(64, 64), confidence=0.3, nms_iou=0.5,
              max_det=50, variables=variables, letterbox_image=False)
    mine = YOLOPredictor(device="cpu", **kw)
    ref = JaxPredictor(**kw)
    rgb, nir = _pil_pair(21, (72, 48))
    (b0, s0, c0), (b1, s1, c1) = mine.detect(rgb, nir), ref.detect(rgb, nir)
    assert len(b0) == len(b1) > 0
    np.testing.assert_array_equal(c0, np.asarray(c1))
    np.testing.assert_allclose(b0, np.asarray(b1), atol=1e-3)
    np.testing.assert_allclose(s0, np.asarray(s1), atol=1e-5)


def test_predictor_on_trained_weights_matches_jax_at_640(tmp_path):
    """The one 640² case: the port's YOLOPredictor against the JAX one on
    tests/fixtures/ab_weights_f16.npz, float32, on 2 synthetic 480×360
    pairs at conf 0.5, IoU 0.5: the same counts, classes equal, boxes
    within 1 px, scores within 1e-3 (tests/test_fold_shuffle.py:127-131's
    limits on this fixture), and the get_map_txt files line by line within
    those limits (scores as printed, truncated to 4 decimals: 1.1e-3;
    corners truncated by int(): 1 px)."""
    from dcfa_yolo_tpu.infer.predictor import YOLOPredictor as JaxPredictor
    from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset

    make_dataset(str(tmp_path), 2, (480, 360))
    voc = tmp_path / "VOCdevkit" / "VOC2007"
    kw = dict(class_names=["tomato_bunch"], input_shape=(640, 640), phi="n",
              confidence=0.5, nms_iou=0.5, max_det=100, pre_nms_topk=2048,
              compute_dtype="float32", variables=load_flat_npz(str(FIXTURE)))
    preds = {"port": YOLOPredictor(device="cpu", **kw), "jax": JaxPredictor(**kw)}
    total = 0
    for i in range(2):
        rgb = Image.open(voc / "JPEGImages_rgb" / f"{i:06d}.png")
        nir = Image.open(voc / "JPEGImages_nir" / f"{i:06d}.png")
        (b0, s0, c0), (b1, s1, c1) = (preds[k].detect(rgb, nir) for k in ("port", "jax"))
        assert len(b0) == len(b1)
        total += len(b0)
        np.testing.assert_array_equal(c0, np.asarray(c1))
        assert np.abs(b0 - np.asarray(b1)).max(initial=0) <= 1.0
        assert np.abs(s0 - np.asarray(s1)).max(initial=0) < 1e-3
        for k, p in preds.items():
            p.get_map_txt(f"{i:06d}", rgb, nir, ["tomato_bunch"], str(tmp_path / k))
        lines = [(tmp_path / k / "detection-results" / f"{i:06d}.txt").read_text()
                 .splitlines() for k in ("port", "jax")]
        assert len(lines[0]) == len(lines[1]) == len(b0)
        for a, b in zip(*lines):
            a, b = a.split(), b.split()
            assert a[0] == b[0] and abs(float(a[1]) - float(b[1])) <= 1.1e-3
            assert all(abs(int(x) - int(y)) <= 1 for x, y in zip(a[2:], b[2:]))
    assert total > 0, "degenerate: the trained fixture detected nothing"
