"""The port's paired serving graph (`dcfa_yolo_tpu_torch/models/pairing.py`,
`DCFAYolo(pair_backbones=True)`) against the JAX package's
(`dcfa_yolo_tpu/models/pairing.py`) and against its own unpaired graph, on
the CPU, the cases of tests/test_pair_backbones.py.

Weights: `synth_state_dict(manifest, 0)` (lively statistics) through the
JAX importer into the flax tree, folded by the JAX package on one side and
carried by `from_jax_variables` then folded by the port on the other.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from dcfa_yolo_tpu.config import ModelConfig as JaxModelConfig
from dcfa_yolo_tpu.models import pairing as jax_pairing
from dcfa_yolo_tpu.models.reparam import fold_shuffle_variables
from dcfa_yolo_tpu.models.torch_import import import_state_dict
from dcfa_yolo_tpu.models.yolo import DCFAYolo as JaxDCFAYolo
from dcfa_yolo_tpu.utils.golden import synth_state_dict
from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.infer import pipeline
from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
from dcfa_yolo_tpu_torch.models import pairing
from dcfa_yolo_tpu_torch.models.convert import from_jax_variables, load_flat_npz
from dcfa_yolo_tpu_torch.models.reparam import (fold_shuffle_state_dict,
                                                serving_state_dict)
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo, init_model

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "ab_weights_f16.npz"
# tests/test_torch_model.py's float32 tolerances, (rtol, atol)
TOL = {"feat": (1e-3, 2e-4), "dbox": (1e-3, 5e-4), "cls": (1e-3, 2e-4)}
HW = (64, 64)


@pytest.fixture(scope="module")
def setup(manifest):
    """The synth weights as JAX folded and paired variables, and the port's
    folded state_dict and paired model built from the same tree."""
    jmodel = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi="n", input_shape=HW))
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    template = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), dummy, dummy, train=False))
    variables, _ = import_state_dict(synth_state_dict(manifest, seed=0),
                                     template, strict=True)
    fvars = fold_shuffle_variables(variables)
    pvars = jax.jit(jax_pairing.pair_backbone_variables)(fvars)
    cfg = ModelConfig(num_classes=1, phi="n", input_shape=HW)
    fsd = fold_shuffle_state_dict(from_jax_variables(variables))
    folded = DCFAYolo(cfg, fold_shuffle=True)
    folded.load_state_dict(fsd, strict=True)
    paired = DCFAYolo(cfg, fold_shuffle=True, pair_backbones=True)
    paired.load_state_dict(pairing.pair_backbone_state_dict(fsd), strict=True)
    rng = np.random.default_rng(0)
    rgb = rng.random((2, *HW, 3), dtype=np.float32)
    nir = rng.random((2, *HW, 3), dtype=np.float32)
    return dict(fvars=fvars, pvars=pvars, fsd=fsd, folded=folded.eval(),
                paired=paired.eval(), rgb=rgb, nir=nir)


def _run(model, rgb, nir):
    with torch.inference_mode():
        return model(torch.from_numpy(rgb), torch.from_numpy(nir))


@pytest.mark.parametrize("c,nb", [(3, 2), (16, 2), (32, 4), (64, 4), (512, 8)])
def test_pair_layout_matches_jax(c, nb):
    """The cases of tests/test_pair_backbones.py:26, equal to JAX's."""
    for mine, ref in zip(pairing.pair_layout(c, nb), jax_pairing.pair_layout(c, nb)):
        np.testing.assert_array_equal(mine, ref)
    with pytest.raises(ValueError):
        pairing.pair_layout(3, 4)


@pytest.mark.parametrize("kind", ["dense", "dw", "spatial", "vec"])
def test_pair_blocks_match_jax_exactly(kind):
    """`_pair_dense` / `_pair_dw` / `_pair_spatial` / `_pair_vec` equal to
    JAX's, HWIO transposed to OIHW, bit for bit."""
    rng = np.random.default_rng(1)

    def hwio(shape):
        return rng.standard_normal(shape).astype(np.float32)

    def oihw(k):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1)))

    if kind == "dense":
        kr, kn = hwio((3, 3, 8, 4)), hwio((3, 3, 8, 4))
        for nb_in, nb_out in ((4, 2), (2, 4), (8, 2), (2, 2)):
            ref = jax_pairing._pair_dense(jnp.asarray(kr), jnp.asarray(kn), nb_in, nb_out)
            mine = pairing._pair_dense(oihw(kr), oihw(kn), nb_in, nb_out)
            assert torch.equal(mine, oihw(ref))
    elif kind == "dw":
        kr, kn = hwio((3, 3, 1, 8)), hwio((3, 3, 1, 8))
        for nb in (2, 4):
            ref = jax_pairing._pair_dw(kr, kn, nb)
            assert torch.equal(pairing._pair_dw(oihw(kr), oihw(kn), nb), oihw(ref))
    elif kind == "spatial":
        kr, kn = hwio((7, 7, 2, 1)), hwio((7, 7, 2, 1))
        ref = jax_pairing._pair_spatial(kr, kn)
        assert torch.equal(pairing._pair_spatial(oihw(kr), oihw(kn)), oihw(ref))
    else:
        vr, vn = hwio((16,)), hwio((16,))
        for nb in (2, 4, 8):
            ref = np.array(jax_pairing._pair_vec(vr, vn, nb))
            mine = pairing._pair_vec(torch.from_numpy(vr), torch.from_numpy(vn), nb)
            assert torch.equal(mine, torch.from_numpy(ref))


def test_pair_state_dict_equals_jax_transform(setup):
    """pair_backbone_state_dict(fold_shuffle_state_dict(sd)) equals the JAX
    pair_backbone_variables(fold_shuffle_variables(v)) carried by
    from_jax_variables, key for key, bit for bit; the paired model loads it
    strictly, the consumed subtrees are gone, and the nonzero weights of a
    paired kernel are those of its two sources."""
    mine = pairing.pair_backbone_state_dict(setup["fsd"])
    ref = from_jax_variables(setup["pvars"])
    assert mine.keys() == ref.keys()
    for k in ref:
        assert torch.equal(mine[k], ref[k]), k
    assert not any(k.startswith(("backbone_rgb", "cbam_nir_")) for k in mine)
    assert mine.keys() == setup["paired"].state_dict().keys()
    kp = mine["backbone_pair.dark3_conv.conv.weight"]
    both = torch.cat([setup["fsd"][f"backbone_{m}.dark3_conv.conv.weight"].flatten()
                      for m in ("rgb", "nir")])
    assert torch.equal(torch.sort(kp[kp != 0]).values, torch.sort(both[both != 0]).values)
    assert (kp == 0).float().mean() >= 0.5


def test_paired_forward_matches_jax(setup):
    """The port's paired forward at 64² float32 against the JAX paired
    forward on the same weights, at tests/test_torch_model.py's TOL."""
    jmodel = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi="n", input_shape=HW),
                         fold_shuffle=True, pair_backbones=True)
    ref = jax.jit(lambda v, r, n: jmodel.apply(v, r, n, train=False))(
        setup["pvars"], setup["rgb"], setup["nir"])
    out = _run(setup["paired"], setup["rgb"], setup["nir"])
    for level in range(3):
        np.testing.assert_allclose(out.feats[level].numpy(),
                                   np.asarray(ref.feats[level]), *TOL["feat"])
    np.testing.assert_allclose(out.dbox.numpy(), np.asarray(ref.dbox), *TOL["dbox"])
    np.testing.assert_allclose(out.cls.numpy(), np.asarray(ref.cls), *TOL["cls"])


def test_paired_matches_unpaired(setup):
    """Within the port, the paired graph against the folded unpaired one:
    the same math up to summation order (tests/test_pair_backbones.py:99-102)."""
    base = _run(setup["folded"], setup["rgb"], setup["nir"])
    pair = _run(setup["paired"], setup["rgb"], setup["nir"])
    np.testing.assert_allclose(pair.dbox.numpy(), base.dbox.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pair.cls.numpy(), base.cls.numpy(), rtol=1e-4, atol=1e-5)


def _initial_state(cfg, seed):
    """Weights of the kind flax's initial state has (the JAX
    `init_model` that tests/test_pair_backbones.py:145 serves): conv kernels
    N(0, 1/fan_in), BN at identity, biases 0, BiFPN weights 1."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in DCFAYolo(cfg).state_dict().items():
        if v.dim() == 4:
            v = torch.from_numpy((rng.standard_normal(v.shape)
                                  / np.sqrt(np.prod(v.shape[1:]))).astype(np.float32))
        elif k.endswith(".bias") and ".bn." not in k and "_bn" not in k:
            v = torch.zeros_like(v)
        sd[k] = v
    return sd


def test_paired_pipeline_kernel_stem_against_plain_stem(setup, monkeypatch):
    """`detect_batch` on the paired graph in bf16: the kernel stem (kernel
    A's plain version on the CPU, on the modality slices of the
    block-diagonal stem) against the paired model's own ConvMaxpool stem,
    with tests/test_pair_backbones.py:137-158's inputs and limits on
    weights of that test's kind (`_initial_state`, 3 classes).  The slices
    are exact: on the synth weights the paired model's two stem maps equal
    the unpaired model's bit for bit.  'auto' resolves the kernel for the
    paired phi='n' bf16 model on an sm_90 card."""
    cfg = ModelConfig(num_classes=1, phi="n", input_shape=HW, compute_dtype="bfloat16")
    models = {}
    for pair in (False, True):
        models[pair] = DCFAYolo(cfg, fold_shuffle=True, pair_backbones=pair).eval()
        models[pair].load_state_dict(pairing.pair_backbone_state_dict(setup["fsd"])
                                     if pair else setup["fsd"], strict=True)
    raw = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 40, 72, 3),
                                                             dtype=np.uint8))
    for a, b in zip(*(pipeline._kernel_stem_outs(models[p], raw, raw.flip(1))
                      for p in (False, True))):
        assert torch.equal(a, b)

    cfg = ModelConfig(num_classes=3, phi="n", input_shape=HW, compute_dtype="bfloat16")
    model = DCFAYolo(cfg, fold_shuffle=True, pair_backbones=True).eval()
    model.load_state_dict(serving_state_dict(_initial_state(cfg, 0), False, True, True),
                          strict=True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (9, 0))
    assert pipeline.resolve_stem("auto", model.cfg, torch.device("cuda")) == "kernel"
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (2, 48, 56, 3), dtype=np.uint8)
    nir = rng.integers(0, 256, (2, 48, 56, 3), dtype=np.uint8)
    hw = np.tile([48.0, 56.0], (2, 1)).astype(np.float32)
    kw = dict(conf_thres=0.01, iou_thres=0.5, max_det=20, pre_nms_topk=64, nms="plain")
    calls = []
    orig = pipeline.stem_eval
    monkeypatch.setattr(pipeline, "stem_eval",
                        lambda *a: calls.append(a[1].shape) or orig(*a))
    a = pipeline.detect_batch(model, rgb, nir, hw, stem="plain", **kw)
    b = pipeline.detect_batch(model, rgb, nir, hw, stem="kernel", **kw)
    assert calls == [(16, 3, 3, 3)] * 2
    assert torch.equal(a.valid, b.valid) and bool(a.valid.any())
    assert (a.boxes - b.boxes).abs().max() < 1e-2
    assert (a.scores - b.scores).abs().max() < 1e-3


def test_paired_heatmap_matches_unpaired(setup):
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (1, 40, 72, 3), dtype=np.uint8)
    nir = rng.integers(0, 256, (1, 40, 72, 3), dtype=np.uint8)
    for a, b in zip(pipeline.heatmap_batch(setup["paired"], rgb, nir),
                    pipeline.heatmap_batch(setup["folded"], rgb, nir)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_detection_agreement_trained():
    """The paired predictor on the trained fixture against the folded one,
    float32, 640², one synthetic 480×360 pair: the same counts (more than
    0) and classes, boxes within 1 px, scores within 1e-3
    (tests/test_pair_backbones.py:198-202)."""
    from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        make_dataset(tmp, 1, (480, 360))
        voc = Path(tmp) / "VOCdevkit" / "VOC2007"
        rgb = np.asarray(Image.open(voc / "JPEGImages_rgb" / "000000.png"))
        nir = np.asarray(Image.open(voc / "JPEGImages_nir" / "000000.png"))
    sd = from_jax_variables(load_flat_npz(str(FIXTURE)))
    kw = dict(class_names=["tomato_bunch"], input_shape=(640, 640), phi="n",
              confidence=0.5, nms_iou=0.5, max_det=100, pre_nms_topk=2048,
              compute_dtype="float32", fold_shuffle=True, device="cpu")
    results = {}
    for pair in (False, True):
        pred = YOLOPredictor(state_dict=serving_state_dict(sd, False, True, pair),
                             pair_backbones=pair, **kw)
        results[pair] = pred.detect(rgb, nir)
    (b0, s0, c0), (b1, s1, c1) = results[False], results[True]
    assert len(s0) == len(s1) > 0
    np.testing.assert_array_equal(c0, c1)
    assert np.abs(b0 - b1).max() <= 1.0
    assert np.abs(s0 - s1).max() < 1e-3


def test_pair_backbones_needs_fold_and_eval(setup):
    """Without fold_shuffle it raises, in the model, the weight transform
    and the predictor; in train mode the forward raises."""
    cfg = ModelConfig(num_classes=1, phi="n", input_shape=HW)
    with pytest.raises(ValueError, match="fold_shuffle=True"):
        DCFAYolo(cfg, pair_backbones=True)
    with pytest.raises(ValueError, match="fold_shuffle=True"):
        serving_state_dict(setup["fsd"], pair_backbones=True)
    with pytest.raises(ValueError, match="fold_shuffle=True"):
        YOLOPredictor(["a"], input_shape=HW, pair_backbones=True, device="cpu")
    model = init_model(cfg, 0, "cpu", fold_shuffle=True, pair_backbones=True).train()
    x = torch.zeros((1, *HW, 3))
    with pytest.raises(ValueError, match="serving-only"):
        model(x, x)
    with pytest.raises(ValueError, match="serving-only"):
        model.train_feats(x, x)
