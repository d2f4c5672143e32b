"""Port serving weight transforms (dcfa_yolo_tpu_torch/models/reparam.py) and
the deploy / folded graphs against the JAX package, float32 on the CPU.

Weights: `synth_state_dict(manifest, 0)` through the JAX importer (BN
statistics far from the identity, so the RepGhost fusion is not trivial),
then through the port's carrier.  Tolerances: the transforms are the same
float32 formulas (deploy within 1e-6) or permutations (fold, bitwise); the
graphs are held at the JAX package's own tolerances for the same
comparisons (tests/test_reparam.py:66-69, tests/test_fold_shuffle.py:56-59)
and at tests/test_torch_model.py's across the two frameworks.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfa_yolo_tpu.config import ModelConfig as JaxModelConfig
from dcfa_yolo_tpu.models import reparam as jreparam
from dcfa_yolo_tpu.models.torch_import import import_state_dict
from dcfa_yolo_tpu.models.yolo import DCFAYolo as JaxDCFAYolo
from dcfa_yolo_tpu.models.yolo import count_params as jax_count_params
from dcfa_yolo_tpu.utils.golden import synth_state_dict
from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.models import reparam
from dcfa_yolo_tpu_torch.models.convert import from_jax_variables
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo, count_params, init_model

torch.set_num_threads(1)

HW = (64, 64)
TOL = {"feat": (1e-3, 2e-4), "dbox": (1e-3, 5e-4), "cls": (1e-3, 2e-4)}  # test_torch_model


@pytest.fixture(scope="module")
def jax_variables(manifest):
    model = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi="n"))
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    template = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), dummy, dummy, train=False))
    variables, _ = import_state_dict(synth_state_dict(manifest, seed=0),
                                     template, strict=True)
    return variables


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return (rng.random((2, *HW, 3), dtype=np.float32),
            rng.random((2, *HW, 3), dtype=np.float32))


def _port(sd, deploy=False, fold_shuffle=False, compute_dtype="float32"):
    model = DCFAYolo(ModelConfig(num_classes=1, phi="n", input_shape=HW,
                                 compute_dtype=compute_dtype),
                     deploy=deploy, fold_shuffle=fold_shuffle)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _forward(model, inputs):
    with torch.inference_mode():
        return model(*(torch.from_numpy(x) for x in inputs))


def test_deploy_state_dict_matches_jax(jax_variables):
    mine = reparam.deploy_state_dict(from_jax_variables(jax_variables))
    ref = from_jax_variables(jreparam.deploy_variables(jax_variables))
    assert sorted(mine) == sorted(ref)
    assert "conv3_for_upsample1.m0.ghost1.cheap_conv.bias" in mine
    assert not any(".cheap_bn." in k or ".fusion_bn." in k for k in mine)
    for k in ref:
        np.testing.assert_allclose(mine[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("deployed", [False, True])
def test_fold_and_unfold_match_jax_bitwise(jax_variables, deployed):
    """Permutations, so bitwise: fold and unfold against the JAX transforms
    (on the train tree and on the deployed one), unfold ∘ fold = identity."""
    v = jreparam.deploy_variables(jax_variables) if deployed else jax_variables
    sd = from_jax_variables(v)
    folded = reparam.fold_shuffle_state_dict(sd)
    ref = from_jax_variables(jreparam.fold_shuffle_variables(v))
    assert sorted(folded) == sorted(ref)
    for k in ref:
        assert torch.equal(folded[k], ref[k]), k
    assert sum(not torch.equal(folded[k], sd[k]) for k in sd) == 18
    unfolded = reparam.unfold_shuffle_state_dict(folded)
    ref_unfold = from_jax_variables(jreparam.unfold_shuffle_variables(
        jreparam.fold_shuffle_variables(v)))
    for k in sd:
        assert torch.equal(unfolded[k], sd[k]), k
        assert torch.equal(unfolded[k], ref_unfold[k]), k


def test_deploy_and_folded_graphs_match_train_graph(jax_variables, inputs):
    """The port's deploy and folded graphs against its train graph, at the
    JAX package's tolerances for the same comparisons."""
    sd = from_jax_variables(jax_variables)
    base = _forward(_port(sd), inputs)
    dep = _forward(_port(reparam.deploy_state_dict(sd), deploy=True), inputs)
    np.testing.assert_allclose(dep.dbox.numpy(), base.dbox.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dep.cls.numpy(), base.cls.numpy(), rtol=1e-4, atol=1e-4)
    fold = _forward(_port(reparam.fold_shuffle_state_dict(sd), fold_shuffle=True), inputs)
    np.testing.assert_allclose(fold.dbox.numpy(), base.dbox.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(fold.cls.numpy(), base.cls.numpy(), rtol=1e-4, atol=1e-5)


def test_deploy_folded_forward_matches_jax(jax_variables, inputs):
    """Port DCFAYolo(deploy=True, fold_shuffle=True) on the JAX-transformed
    tree (strict load: `cheap_conv/bias` reaches `cheap_conv.bias`) against
    the JAX DCFAYolo(deploy=True, fold_shuffle=True).apply."""
    v = jreparam.fold_shuffle_variables(jreparam.deploy_variables(jax_variables))
    jmodel = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi="n", input_shape=HW),
                         deploy=True, fold_shuffle=True)
    ref = jax.jit(lambda v_, r, n: jmodel.apply(v_, r, n, train=False))(v, *inputs)
    out = _forward(_port(from_jax_variables(v), deploy=True, fold_shuffle=True), inputs)
    for level in range(3):
        np.testing.assert_allclose(out.feats[level].numpy(), np.asarray(ref.feats[level]),
                                   *TOL["feat"])
    np.testing.assert_allclose(out.dbox.numpy(), np.asarray(ref.dbox), *TOL["dbox"])
    np.testing.assert_allclose(out.cls.numpy(), np.asarray(ref.cls), *TOL["cls"])


def test_cast_conv_kernels_bit_identical(jax_variables, inputs):
    """Pre-cast bf16 conv kernels: the same values as the JAX cast, only 4-D
    leaves cast, and a bit-identical bf16 forward of the deploy + folded
    graph (tests/test_cast_weights.py:26-55 pattern)."""
    v = jreparam.fold_shuffle_variables(jreparam.deploy_variables(jax_variables))
    sd = from_jax_variables(v)
    cast = reparam.cast_conv_kernels(sd)
    ref = from_jax_variables(jreparam.cast_conv_kernels(v))
    kinds = {(t.dim() == 4, t.dtype) for t in cast.values()}
    assert kinds == {(True, torch.bfloat16), (False, torch.float32)}
    for k in ref:
        assert torch.equal(cast[k].float(), ref[k]), k
    kw = dict(deploy=True, fold_shuffle=True, compute_dtype="bfloat16")
    base = _forward(_port(sd, **kw), inputs)
    model = _port(sd, **kw)
    model.load_state_dict(cast, strict=True, assign=True)
    assert model.backbone_rgb.dark2_conv.conv.weight.dtype == torch.bfloat16
    assert model.backbone_rgb.dark2_conv.bn.weight.dtype == torch.float32
    fast = _forward(model, inputs)
    for a, b in zip((base.dbox, base.cls, *base.feats), (fast.dbox, fast.cls, *fast.feats)):
        assert torch.equal(a, b)


def test_param_counts_match_jax(jax_variables):
    dep = jreparam.deploy_variables(jax_variables)
    cfg = ModelConfig(num_classes=1, phi="n", input_shape=HW)
    for deploy, ref in ((False, jax_variables), (True, dep)):
        model = init_model(cfg, 0, "cpu", deploy=deploy, fold_shuffle=deploy)
        assert count_params(model) == jax_count_params(ref)
    # each fused module drops 4 BN params a channel and gains 1 bias
    assert jax_count_params(jax_variables) - jax_count_params(dep) == 1_728
