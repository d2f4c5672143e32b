"""The port's optimizer, schedule, EMA and weight init
(dcfa_yolo_tpu_torch/train/optim.py, schedule.py, ema.py, init_weights.py)
against the reference goldens and the JAX package, on the CPU.

Tolerances: the LR schedules to rtol 1e-10 (pure Python on both sides, as
tests/test_train.py holds them); one optimizer step to rtol 1e-6 (the same
float32 formulas in another summation order for the gradient norm); the EMA
to rtol 1e-6; the weight init bit for bit (the same numpy draws in the same
order).
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
from dcfa_yolo_tpu.models.yolo import DCFAYolo as JaxDCFAYolo
from dcfa_yolo_tpu.train.ema import init_ema, update_ema
from dcfa_yolo_tpu.train.init_weights import reference_weights_init as jax_init
from dcfa_yolo_tpu.train.optim import build_optimizer
from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
from dcfa_yolo_tpu_torch.models.convert import from_jax_variables
from dcfa_yolo_tpu_torch.models.yolo import init_model
from dcfa_yolo_tpu_torch.train.ema import ModelEMA
from dcfa_yolo_tpu_torch.train.optim import Optimizer
from dcfa_yolo_tpu_torch.train.schedule import get_lr_scheduler

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "goldens" / "train.npz"


@pytest.fixture(scope="module")
def tr():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("kind", ["cos", "step"])
def test_schedule_matches_reference(tr, kind):
    fn = get_lr_scheduler(kind, 0.01, 0.0001, 200)
    np.testing.assert_allclose([fn(e) for e in range(200)], tr[f"lr_{kind}"],
                               rtol=1e-10)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_scaled_lrs_match_jax(opt):
    for bs in (2, 16, 64, 256):
        assert (TrainConfig(optimizer_type=opt).scaled_lrs(bs)
                == JaxTrainConfig(optimizer_type=opt).scaled_lrs(bs))


def _tree(rng):
    """A flax-like parameter tree with every decay class: conv kernels
    (decay), BN scale and biases (none) and the BiFPN weights (none)."""
    return {"backbone_rgb": {"conv": {"kernel": rng.standard_normal((3, 3, 4, 8))},
                             "bn": {"scale": 1 + rng.standard_normal(8) * 0.1,
                                    "bias": rng.standard_normal(8) * 0.1}},
            "head": {"conv": {"kernel": rng.standard_normal((1, 1, 8, 5)),
                              "bias": rng.standard_normal(5)}},
            "bi_fpn": {"w": np.ones(3)}}


def _port_named(tree):
    named = []
    for path, v in (("backbone_rgb.conv.weight", tree["backbone_rgb"]["conv"]["kernel"]),
                    ("backbone_rgb.bn.weight", tree["backbone_rgb"]["bn"]["scale"]),
                    ("backbone_rgb.bn.bias", tree["backbone_rgb"]["bn"]["bias"]),
                    ("head.conv.weight", tree["head"]["conv"]["kernel"]),
                    ("head.conv.bias", tree["head"]["conv"]["bias"]),
                    ("bi_fpn.w", tree["bi_fpn"]["w"])):
        v = np.asarray(v, np.float32)
        named.append((path, torch.from_numpy(v.transpose(3, 2, 0, 1).copy()
                                             if v.ndim == 4 else v.copy())))
    return named


@pytest.mark.parametrize("opt,freeze", [("sgd", False), ("adam", False),
                                        ("sgd", True)])
def test_optimizer_steps_match_optax(opt, freeze):
    """Three steps with clipping active (gradient norm above 10), against
    the optax chain of `build_optimizer` plus the JAX trainer's freeze
    masking (`trainer.py:94-105`)."""
    from dcfa_yolo_tpu.train.optim import frozen_backbone_mask
    from dcfa_yolo_tpu.train.trainer import _mask_frozen_opt_state

    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), _tree(rng))
    cfg_kw = dict(optimizer_type=opt, momentum=0.9 if opt == "adam" else 0.937)
    tx = build_optimizer(JaxTrainConfig(**cfg_kw), tree)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(params)
    mask = frozen_backbone_mask(params)
    named = _port_named(tree)
    port = Optimizer(TrainConfig(**cfg_kw), named)
    lr = 1e-2
    for step in range(3):
        g_tree = jax.tree_util.tree_map(
            lambda v: np.asarray(rng.standard_normal(v.shape) * 3, np.float32), tree)
        g = jax.tree_util.tree_map(jnp.asarray, g_tree)
        if freeze:
            g = jax.tree_util.tree_map(lambda x, m: jnp.zeros_like(x) if m else x,
                                       g, mask)
        upd, state = tx.update(g, state, params)
        if freeze:
            upd = jax.tree_util.tree_map(lambda u, m: jnp.zeros_like(u) if m else u,
                                         upd, mask)
            state = _mask_frozen_opt_state(tx, state, mask)
        params = jax.tree_util.tree_map(lambda p, u: p + u * lr, params, upd)
        port.step([t for _, t in _port_named(g_tree)], lr, freeze_backbone=freeze)
    for (name, p), ref in zip(named, _port_named(jax.tree_util.tree_map(np.asarray, params))):
        np.testing.assert_allclose(p.numpy(), ref[1].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    if freeze:
        np.testing.assert_array_equal(named[0][1].numpy(), _port_named(tree)[0][1].numpy())
        assert not port.trace[0].any()


def test_ema_matches_jax():
    rng = np.random.default_rng(6)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    sd0 = {k: v.clone() for k, v in model.state_dict().items() if v.is_floating_point()}
    ema = ModelEMA(model, updates=5)
    ref = init_ema({k: v.numpy() for k, v in sd0.items()}, 5)
    for _ in range(3):
        with torch.no_grad():
            for v in model.state_dict().values():
                if v.is_floating_point():
                    v.add_(torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)))
        ema.update(model, decay=0.9999, tau=2000.0)
        ref = update_ema(ref, {k: v.numpy() for k, v in model.state_dict().items()
                               if v.is_floating_point()}, decay=0.9999, tau=2000.0)
    assert ema.updates == int(ref.updates) == 8
    for k, v in ref.variables.items():
        np.testing.assert_allclose(ema.variables[k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def jax_variables():
    """The flax initial state of the model without compiling its init: the
    tree from `jax.eval_shape`, filled as flax's initializers fill the
    leaves the reference init leaves alone (BiFPN w = 1, running mean 0
    and var 1); every other leaf is redrawn or zeroed."""
    cfg = JaxModelConfig(num_classes=1, phi="n", input_shape=(64, 64))
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JaxDCFAYolo(cfg).init(
        jax.random.PRNGKey(0), dummy, dummy, train=False))
    fill = lambda path, x: (np.ones if jax.tree_util.keystr(path).endswith(
        ("['w']", "['var']")) else np.zeros)(x.shape, np.float32)
    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def test_reference_weights_init_is_bit_identical(jax_variables):
    """init_model(train=True) draws the reference init in the JAX package's
    order: the port's state equals the JAX package's, bit for bit."""
    ref = from_jax_variables({"params": jax_init(jax_variables["params"], seed=3),
                              "batch_stats": jax_variables["batch_stats"]})
    model = init_model(ModelConfig(num_classes=1, phi="n", input_shape=(64, 64)),
                       seed=3, device="cpu", train=True)
    assert model.training
    sd = model.state_dict()
    assert sd.keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming", "orthogonal"])
def test_init_kernel_types_match_jax(init_type):
    """Each kernel distribution draws what the JAX package draws, including
    the orthogonal sign fix on wide kernels (fan-in < out channels)."""
    from dcfa_yolo_tpu.train.init_weights import _init_kernel as jax_kernel
    from dcfa_yolo_tpu_torch.train.init_weights import _init_kernel

    for shape in ((3, 3, 16, 32), (3, 3, 1, 16), (1, 1, 64, 8)):
        got = _init_kernel(np.random.Generator(np.random.PCG64(9)), shape,
                           init_type, 0.5)
        ref = jax_kernel(np.random.Generator(np.random.PCG64(9)), shape,
                         init_type, 0.5)
        np.testing.assert_array_equal(got, ref)
