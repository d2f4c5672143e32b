"""Port model (dcfa_yolo_tpu_torch/models/*) vs the PyTorch reference goldens
and vs the JAX `DCFAYolo.apply`, float32 on the CPU.

Weights: `synth_state_dict(manifest, 0)` (the reference's key space) goes
through the JAX importer into the flax tree, then through the port's
carrier `from_jax_variables` — so the test also pins that the carrier and
the port's module names cover the whole tree.  Tolerances are those of
tests/test_model_parity.py: both sides are float32 with different
summation orders.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfa_yolo_tpu.config import ModelConfig as JaxModelConfig
from dcfa_yolo_tpu.models.torch_import import import_state_dict
from dcfa_yolo_tpu.models.yolo import DCFAYolo as JaxDCFAYolo
from dcfa_yolo_tpu.utils.golden import synth_input, synth_state_dict
from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.models.convert import from_jax_variables
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo, count_params

torch.set_num_threads(1)

TOL = {"tap": (5e-2, 5e-3), "feat": (1e-3, 2e-4), "dbox": (1e-3, 5e-4),
       "cls": (1e-3, 2e-4)}  # (rtol, atol)


@pytest.fixture(scope="module")
def jax_variables(manifest):
    """Synth weights in the flax tree; the template comes from eval_shape
    (parameter shapes do not depend on the input size)."""
    model = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi="n"))
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    template = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), dummy, dummy, train=False))
    variables, _ = import_state_dict(synth_state_dict(manifest, seed=0),
                                     template, strict=True)
    return variables


def _port_model(variables, input_hw):
    model = DCFAYolo(ModelConfig(num_classes=1, phi="n", input_shape=input_hw))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model.eval()


def test_carrier_loads_strict_and_counts_params(jax_variables):
    model = _port_model(jax_variables, (640, 640))
    # reference: 2,678,866 including the 16 frozen DFL weights (BASELINE.md);
    # DFL is a function here, as in the JAX package
    assert count_params(model) == 2_678_866 - 16
    sd = model.state_dict()
    k = np.asarray(jax_variables["params"]["backbone_rgb"]["dark2_conv"]["conv"]["kernel"])
    np.testing.assert_array_equal(sd["backbone_rgb.dark2_conv.conv.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["cv2_0_0.bn.running_var"].numpy(),
        np.asarray(jax_variables["batch_stats"]["cv2_0_0"]["bn"]["var"]))


def _nhwc(x):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


def test_forward_matches_reference_goldens(jax_variables, golden_model_fwd):
    model = _port_model(jax_variables, (640, 640))
    taps = {}

    def hook(name, idx=None):
        def fn(_mod, _inp, out):
            taps[name] = (out if idx is None else out[idx]).float().numpy()
        return fn

    for mod, name, idx in (
            (model.conv3_for_upsample1, "neck_p4_up1", None),
            (model.conv3_for_upsample2, "neck_p3", None),
            (model.conv3_for_downsample1, "neck_p4_down", None),
            (model.conv3_for_downsample2, "neck_p5", None),
            (model.backbone_rgb, "backbone_rgb_feat1", 0),
            (model.backbone_rgb, "backbone_rgb_feat2", 1),
            (model.backbone_nir, "backbone_nir_feat1", 0)):
        mod.register_forward_hook(hook(name, idx))
    rgb = _nhwc(synth_input("rgb", (1, 3, 640, 640), seed=0))
    nir = _nhwc(synth_input("nir", (1, 3, 640, 640), seed=0))
    with torch.inference_mode():
        out = model(torch.from_numpy(rgb), torch.from_numpy(nir))

    rtol, atol = TOL["tap"]
    for name, mine in taps.items():
        ref = golden_model_fwd[f"tap_{name}"].astype(np.float32)  # NCHW
        np.testing.assert_allclose(mine, ref, rtol=rtol, atol=atol,
                                   err_msg=f"tap {name}")
    for level, key in enumerate(["feat_p3", "feat_p4", "feat_p5"]):
        np.testing.assert_allclose(out.feats[level].numpy(),
                                   _nhwc(golden_model_fwd[key]),
                                   *TOL["feat"], err_msg=key)
    np.testing.assert_allclose(out.dbox.numpy(),
                               np.transpose(golden_model_fwd["dbox"], (0, 2, 1)),
                               *TOL["dbox"])
    np.testing.assert_allclose(out.cls.numpy(),
                               np.transpose(golden_model_fwd["cls"], (0, 2, 1)),
                               *TOL["cls"])


def test_forward_matches_jax_apply(jax_variables):
    hw = (128, 128)
    rng = np.random.default_rng(0)
    rgb = rng.random((2, *hw, 3), dtype=np.float32)
    nir = rng.random((2, *hw, 3), dtype=np.float32)
    jmodel = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi="n", input_shape=hw))
    ref = jax.jit(lambda v, r, n: jmodel.apply(v, r, n, train=False))(
        jax_variables, rgb, nir)
    model = _port_model(jax_variables, hw)
    with torch.inference_mode():
        out = model(torch.from_numpy(rgb), torch.from_numpy(nir))
    for level in range(3):
        np.testing.assert_allclose(out.feats[level].numpy(),
                                   np.asarray(ref.feats[level]), *TOL["feat"])
    np.testing.assert_allclose(out.dbox.numpy(), np.asarray(ref.dbox), *TOL["dbox"])
    np.testing.assert_allclose(out.cls.numpy(), np.asarray(ref.cls), *TOL["cls"])
    np.testing.assert_array_equal(out.anchors.numpy(), np.asarray(ref.anchors))
    np.testing.assert_array_equal(out.strides.numpy(), np.asarray(ref.strides))
