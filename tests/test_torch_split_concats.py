"""The port's split neck concats (`DCFAYolo(split_neck_concats=True)`, the
parts path `ops/conv.py::parts_conv`) against the JAX package's and against
its own unsplit graph, on the CPU, the cases of tests/test_split_concats.py.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from PIL import Image

from dcfa_yolo_tpu.config import ModelConfig as JaxModelConfig
from dcfa_yolo_tpu.models.torch_import import import_state_dict
from dcfa_yolo_tpu.models.yolo import DCFAYolo as JaxDCFAYolo
from dcfa_yolo_tpu.ops.conv import ConvBnAct as JaxConvBnAct
from dcfa_yolo_tpu.utils.golden import synth_state_dict
from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
from dcfa_yolo_tpu_torch.models.convert import from_jax_variables, load_flat_npz
from dcfa_yolo_tpu_torch.models.reparam import serving_state_dict
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo
from dcfa_yolo_tpu_torch.ops.conv import Conv, ConvBnAct, parts_conv

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "ab_weights_f16.npz"
# tests/test_torch_model.py's float32 tolerances, (rtol, atol)
TOL = {"feat": (1e-3, 2e-4), "dbox": (1e-3, 5e-4), "cls": (1e-3, 2e-4)}
HW = (64, 64)


@pytest.fixture(scope="module")
def setup(manifest):
    """The synth weights as a flax tree and as the port's state_dict, and
    one pair of 64² inputs."""
    jmodel = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi="n", input_shape=HW))
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    template = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), dummy, dummy, train=False))
    variables, _ = import_state_dict(synth_state_dict(manifest, seed=0),
                                     template, strict=True)
    rng = np.random.default_rng(0)
    return dict(variables=variables, sd=from_jax_variables(variables),
                rgb=rng.random((2, *HW, 3), dtype=np.float32),
                nir=rng.random((2, *HW, 3), dtype=np.float32))


def _model(sd, **graph):
    model = DCFAYolo(ModelConfig(num_classes=1, phi="n", input_shape=HW), **graph)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _run(model, s):
    with torch.inference_mode():
        return model(torch.from_numpy(s["rgb"]), torch.from_numpy(s["nir"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parts_conv_matches_concat_conv(dtype):
    """The parts path against the concat conv.  float32: ConvBnAct on
    parts against the same block on their concat and against the JAX parts
    path, within summation order.  bf16: `parts_conv` rounds once, as the
    JAX path does (partials in float32, summed in float32): it equals the
    exact conv of the bf16 operands rounded to bf16 in at least 99% of the
    outputs and is nowhere more than one bf16 step from it (partials
    rounded to bf16 and summed in bf16 differ in about half); the block on
    parts equals the block on the concat likewise."""
    rng = np.random.default_rng(4)
    widths = (8, 16, 24)
    parts_np = [rng.standard_normal((2, 6, 5, c)).astype(np.float32) for c in widths]
    jblock = JaxConvBnAct(12, 1, 1)
    jvars = jblock.init(jax.random.PRNGKey(1), jnp.zeros((1, 6, 5, sum(widths))))
    jvars = {"params": {"conv": jvars["params"]["conv"],
                        "bn": {k: 1.0 + 0.3 * rng.standard_normal(12).astype(np.float32)
                               for k in ("scale", "bias")}},
             "batch_stats": {"bn": {"mean": rng.standard_normal(12).astype(np.float32),
                                    "var": rng.uniform(0.5, 1.5, 12).astype(np.float32)}}}
    block = ConvBnAct(sum(widths), 12, 1, 1)
    block.load_state_dict(from_jax_variables(jvars), strict=True)
    block.eval()
    tdt = getattr(torch, dtype)
    parts = tuple(torch.from_numpy(p).permute(0, 3, 1, 2).to(tdt) for p in parts_np)
    with torch.inference_mode():
        split = block(parts).float()
        whole = block(torch.cat(parts, dim=1)).float()
        conv = parts_conv(block.conv, parts).double()
    if dtype == "float32":
        ref = np.asarray(jblock.apply(jvars, tuple(jnp.asarray(p) for p in parts_np)))
        np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(split.permute(0, 2, 3, 1).numpy(), ref,
                                   rtol=1e-5, atol=1e-5)
    else:
        x, w = torch.cat(parts, dim=1).double(), block.conv.weight.to(tdt).double()
        rounded = F.conv2d(x, w).to(tdt).double()
        # one bf16 step; where the terms cancel, of 2^-8 of their magnitudes
        step = 2.0 ** -7 * torch.maximum(rounded.abs(), 2.0 ** -8 * F.conv2d(x.abs(), w.abs()))
        assert ((conv - rounded).abs() <= step).all()
        assert (conv == rounded).double().mean() >= 0.99
        assert (split == whole).double().mean() >= 0.99


def test_parts_conv_rejects_nonpointwise():
    """Parts need a 1x1 ungrouped conv whose in-channels they fill."""
    parts = (torch.ones(1, 3, 4, 4), torch.ones(1, 5, 4, 4))
    with pytest.raises(ValueError, match="1x1 ungrouped"):
        ConvBnAct(8, 8, 3)(parts)
    block = ConvBnAct(8, 8, 1)
    block.conv = Conv(8, 8, 1, g=2)
    with pytest.raises(ValueError, match="1x1 ungrouped"):
        block(parts)
    with pytest.raises(ValueError, match="parts channels 8 != conv in-channels 9"):
        ConvBnAct(9, 8, 1)(parts)


def test_state_dict_keys_identical(setup):
    """The split graph's parameters are the unsplit graph's, key for key
    and shape for shape (tests/test_split_concats.py:59-69), in the train
    graph and in the deploy graph."""
    cfg = ModelConfig(num_classes=1, phi="n", input_shape=HW)
    for deploy in (False, True):
        a = DCFAYolo(cfg, deploy=deploy).state_dict()
        b = DCFAYolo(cfg, deploy=deploy, split_neck_concats=True).state_dict()
        assert list(a) == list(b)
        assert all(a[k].shape == b[k].shape for k in a)


@pytest.mark.parametrize("deploy,fold", [(False, False), (True, True)])
def test_split_matches_unsplit(setup, deploy, fold):
    """Split against unsplit within the port, in the train graph and
    composed with deploy + fold (tests/test_split_concats.py:36-92): up to
    the K-split summation order."""
    sd = serving_state_dict(setup["sd"], deploy, fold)
    graph = dict(deploy=deploy, fold_shuffle=fold)
    base = _run(_model(sd, **graph), setup)
    split = _run(_model(sd, split_neck_concats=True, **graph), setup)
    np.testing.assert_allclose(split.dbox.numpy(), base.dbox.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(split.cls.numpy(), base.cls.numpy(), rtol=1e-4, atol=1e-5)


def test_split_forward_matches_jax(setup):
    """The port's split forward at 64² float32 against the JAX split
    forward on the same weights, at tests/test_torch_model.py's TOL."""
    jmodel = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi="n", input_shape=HW),
                         split_neck_concats=True)
    ref = jax.jit(lambda v, r, n: jmodel.apply(v, r, n, train=False))(
        setup["variables"], setup["rgb"], setup["nir"])
    out = _run(_model(setup["sd"], split_neck_concats=True), setup)
    for level in range(3):
        np.testing.assert_allclose(out.feats[level].numpy(),
                                   np.asarray(ref.feats[level]), *TOL["feat"])
    np.testing.assert_allclose(out.dbox.numpy(), np.asarray(ref.dbox), *TOL["dbox"])
    np.testing.assert_allclose(out.cls.numpy(), np.asarray(ref.cls), *TOL["cls"])


def test_detection_agreement_trained():
    """The fold + split predictor on the trained fixture against the fold
    one, float32, 640², one synthetic 480×360 pair: the same counts (more
    than 0) and classes, boxes within 1 px, scores within 1e-3
    (tests/test_split_concats.py:139-143)."""
    from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset

    with tempfile.TemporaryDirectory() as tmp:
        make_dataset(tmp, 1, (480, 360))
        voc = Path(tmp) / "VOCdevkit" / "VOC2007"
        rgb = np.asarray(Image.open(voc / "JPEGImages_rgb" / "000000.png"))
        nir = np.asarray(Image.open(voc / "JPEGImages_nir" / "000000.png"))
    sd = serving_state_dict(from_jax_variables(load_flat_npz(str(FIXTURE))), False, True)
    kw = dict(class_names=["tomato_bunch"], input_shape=(640, 640), phi="n",
              confidence=0.5, nms_iou=0.5, max_det=100, pre_nms_topk=2048,
              compute_dtype="float32", fold_shuffle=True, state_dict=sd, device="cpu")
    (b0, s0, c0), (b1, s1, c1) = (
        YOLOPredictor(split_neck_concats=split, **kw).detect(rgb, nir)
        for split in (False, True))
    assert len(s0) == len(s1) > 0
    np.testing.assert_array_equal(c0, c1)
    assert np.abs(b0 - b1).max() <= 1.0
    assert np.abs(s0 - s1).max() < 1e-3
