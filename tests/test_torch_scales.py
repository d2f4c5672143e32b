"""The port at other input shapes and other phis, on the CPU: the cases of
tests/test_multiscale.py (320², 320×416, 1280²) and tests/test_phis.py
(the pinned parameter and BN-statistic counts and the 256² forward shapes
of phi n-x), with the port against the JAX package in float32 where a
forward is run.  Shape-only cases build on the `meta` device, as the JAX
tests use `eval_shape`."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfa_yolo_tpu.config import ModelConfig as JaxModelConfig
from dcfa_yolo_tpu.infer.pipeline import detect_batch as jax_detect_batch
from dcfa_yolo_tpu.models.torch_import import import_state_dict
from dcfa_yolo_tpu.models.yolo import DCFAYolo as JaxDCFAYolo
from dcfa_yolo_tpu.utils.golden import synth_state_dict
from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.infer.pipeline import detect_batch
from dcfa_yolo_tpu_torch.models.convert import from_jax_variables, load_flat_npz
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo, count_params

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "ab_weights_f16.npz"
# tests/test_torch_model.py's float32 tolerances, (rtol, atol)
TOL = {"feat": (1e-3, 2e-4), "dbox": (1e-3, 5e-4), "cls": (1e-3, 2e-4)}
# tests/test_phis.py:29-35: phi → (parameters, BN statistics) at 1 class
EXPECTED_COUNTS = {
    "n": (2_678_850, 14_080),
    "s": (9_770_850, 27_392),
    "m": (17_451_202, 44_928),
    "l": (24_325_538, 62_208),
    "x": (37_962_370, 77_760),
}


def _template(cfg: JaxModelConfig):
    model = JaxDCFAYolo(cfg)
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    return jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), dummy, dummy, train=False))


@pytest.fixture(scope="module")
def variables(manifest):
    """The synth weights (phi='n', 1 class) as a flax tree."""
    v, _ = import_state_dict(synth_state_dict(manifest, seed=0),
                             _template(JaxModelConfig(num_classes=1, phi="n")),
                             strict=True)
    return v


def _port(variables, phi, hw):
    model = DCFAYolo(ModelConfig(num_classes=1, phi=phi, input_shape=hw))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model.eval()


def _against_jax(variables, phi, hw, seed):
    """The port's forward against the JAX forward on one (2, H, W) pair;
    returns the port's outputs."""
    rng = np.random.default_rng(seed)
    rgb = rng.random((2, *hw, 3), dtype=np.float32)
    nir = rng.random((2, *hw, 3), dtype=np.float32)
    jmodel = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi=phi, input_shape=hw))
    ref = jax.jit(lambda v, r, n: jmodel.apply(v, r, n, train=False))(variables, rgb, nir)
    with torch.inference_mode():
        out = _port(variables, phi, hw)(torch.from_numpy(rgb), torch.from_numpy(nir))
    for level in range(3):
        np.testing.assert_allclose(out.feats[level].numpy(),
                                   np.asarray(ref.feats[level]), *TOL["feat"])
    np.testing.assert_allclose(out.dbox.numpy(), np.asarray(ref.dbox), *TOL["dbox"])
    np.testing.assert_allclose(out.cls.numpy(), np.asarray(ref.cls), *TOL["cls"])
    np.testing.assert_array_equal(out.anchors.numpy(), np.asarray(ref.anchors))
    return out


@pytest.mark.parametrize("hw", [(320, 320), (320, 416)])
def test_forward_matches_jax(variables, hw):
    """320² and 320×416 (tests/test_multiscale.py:20-28, 46-53): the port
    against JAX at TOL, with Σ (h/s)·(w/s) anchors."""
    out = _against_jax(variables, "n", hw, 0)
    a = sum((hw[0] // s) * (hw[1] // s) for s in (8, 16, 32))
    assert out.dbox.shape == (2, a, 4) and out.anchors.shape == (a, 2)
    assert out.cls.shape == (2, a, 1)


def test_detect_batch_non_square_matches_jax(tmp_path):
    """The serving pipeline at a 320×416 input shape (the letterbox of two
    synthetic 480×360 pairs, decode, NMS, unmap) against the JAX pipeline,
    float32, on the trained fixture (its scores spread, so no near-tied
    pair of detections can swap slots), the plain stem and NMS on both
    sides: the same detections, boxes within 1e-3 px, scores within 1e-5."""
    from PIL import Image

    from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset

    hw = (320, 416)
    variables = load_flat_npz(str(FIXTURE))
    model = _port(variables, "n", hw)
    jmodel = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi="n", input_shape=hw))
    make_dataset(str(tmp_path), 2, (480, 360))
    voc = tmp_path / "VOCdevkit" / "VOC2007"
    rgb, nir = (np.stack([np.asarray(Image.open(voc / f"JPEGImages_{m}" / f"{i:06d}.png"))
                          for i in range(2)]) for m in ("rgb", "nir"))
    image_hw = np.tile([360.0, 480.0], (2, 1)).astype(np.float32)
    kw = dict(conf_thres=0.25, iou_thres=0.5, max_det=100, pre_nms_topk=1024)
    mine = detect_batch(model, rgb, nir, image_hw, nms="plain", stem="plain", **kw)
    ref = jax.jit(lambda r, n: jax_detect_batch(
        jmodel, variables, r, n, image_hw, nms_backend="xla", stem_backend="xla",
        **kw))(rgb, nir)
    np.testing.assert_array_equal(mine.n_candidates.numpy(), np.asarray(ref.n_candidates))
    np.testing.assert_array_equal(mine.valid.numpy(), np.asarray(ref.valid))
    assert bool(mine.valid.any(-1).all())
    np.testing.assert_array_equal(mine.classes.numpy(), np.asarray(ref.classes))
    np.testing.assert_allclose(mine.boxes.numpy(), np.asarray(ref.boxes), atol=1e-3)
    np.testing.assert_allclose(mine.scores.numpy(), np.asarray(ref.scores), atol=1e-5)


def _meta_model(phi, hw):
    with torch.device("meta"):
        return DCFAYolo(ModelConfig(num_classes=1, phi=phi, input_shape=hw)).eval()


def _meta_forward(model, hw):
    x = torch.zeros((1, *hw, 3), device="meta")
    with torch.inference_mode():
        return model(x, x)


def test_1280_shapes():
    """1280² shape-only (tests/test_multiscale.py:30-43)."""
    out = _meta_forward(_meta_model("n", (1280, 1280)), (1280, 1280))
    a = sum((1280 // s) ** 2 for s in (8, 16, 32))
    assert out.dbox.shape == (1, a, 4) and out.anchors.shape == (a, 2)


@pytest.mark.parametrize("phi", list("nsmlx"))
def test_phi_param_and_stat_counts(phi):
    """The pinned counts of tests/test_phis.py:29-35, counted as it counts
    them: trainable parameters (its `params`) and BN running statistics
    (its `batch_stats`)."""
    model = _meta_model(phi, (256, 256))
    assert (count_params(model), sum(b.numel() for b in model.buffers())) \
        == EXPECTED_COUNTS[phi]


@pytest.mark.parametrize("phi", list("nsmlx"))
def test_phi_forward_shapes_at_256(phi):
    """tests/test_phis.py:51-64: the neck's channels fit at every phi."""
    out = _meta_forward(_meta_model(phi, (256, 256)), (256, 256))
    assert out.dbox.shape == (1, 1344, 4) and out.cls.shape == (1, 1344, 1)
    assert [tuple(f.shape) for f in out.feats] == [
        (1, 32, 32, 65), (1, 16, 16, 65), (1, 8, 8, 65)]


def _lively(phi, seed):
    """Weights drawn per flax leaf from `seed`, with the distributions of
    the port's `init_model`."""
    template = _template(JaxModelConfig(num_classes=1, phi=phi))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        if name in ("var", "w"):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif name == "mean":
            v = rng.standard_normal(leaf.shape) * 0.2
        elif name == "scale":
            v = 1.0 + rng.standard_normal(leaf.shape) * 0.1
        else:
            v = rng.standard_normal(leaf.shape) * 0.05
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, template)


def test_phi_s_forward_matches_jax():
    """phi='s' at 64² float32, the port against JAX at TOL, on lively
    weights drawn per flax leaf from a seed (the distributions of the
    port's `init_model`)."""
    _against_jax(_lively("s", 5), "s", (64, 64), 1)


def test_phi_x_forward_matches_jax():
    """phi='x', the largest (80 stem channels, depth-3 stacks, 640 deep
    channels), at 64² float32: the port against JAX at TOL, on lively
    weights."""
    out = _against_jax(_lively("x", 6), "x", (64, 64), 2)
    assert out.cls.shape == (2, 84, 1)
