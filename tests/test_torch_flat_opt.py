"""The port's flat optimizer and EMA tail (dcfa_yolo_tpu_torch/train/flat_opt.py)
against the JAX package's `train/flat_opt.py`, and the trainer's flat tail
against its per-tensor path, on the CPU.

Tolerances: one flat step against the JAX flat step to rtol 2e-6 / atol
1e-7, as tests/test_flat_opt.py holds the JAX flat tail against optax (the
same float32 formulas; the bias corrections' powers round in numpy here and
in XLA there).  The flat-tail trainer against `flat_tail=False`: bit for bit
(the same elementwise ops in the same order, and the clip's norm over the
same per-parameter reductions).  The state round trip and resume: bit for
bit.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from dcfa_yolo_tpu.config import TrainConfig as JaxTrainConfig
from dcfa_yolo_tpu.train import flat_opt as jax_flat
from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
from dcfa_yolo_tpu_torch.models.yolo import init_model
from dcfa_yolo_tpu_torch.profile_train import synthetic_batch
from dcfa_yolo_tpu_torch.train import flat_opt
from dcfa_yolo_tpu_torch.train.trainer import Trainer, TrainState

torch.set_num_threads(1)


def _toy_params(rng):
    """tests/test_flat_opt.py's tree: a backbone kernel (frozen in the freeze
    phase, decayed), the BiFPN weights (untrained here), a neck kernel and
    bias, and a BN scale and bias."""
    return {
        "backbone_rgb": {"c1": {"kernel": rng.standard_normal(
            (3, 3, 4, 8)).astype(np.float32)}},
        "neck": {"bi_fpn": {"w": rng.standard_normal(3).astype(np.float32)},
                 "c2": {"kernel": rng.standard_normal(
                     (1, 1, 8, 4)).astype(np.float32),
                     "bias": rng.standard_normal(4).astype(np.float32)}},
        "head": {"bn": {"scale": rng.standard_normal(8).astype(np.float32),
                        "bias": rng.standard_normal(8).astype(np.float32)}},
    }


def _port_named(tree):
    """The tree's leaves in the JAX ravel order under the port's names
    (conv kernels HWIO → OIHW under `weight`)."""
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    out = []
    for path, v in leaves:
        keys = [p.key for p in path]
        leaf = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
        v = np.asarray(v, np.float32)
        t = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v
        out.append((".".join(keys[:-1] + [leaf]), torch.from_numpy(np.ascontiguousarray(t))))
    return out


def _to_jax_order(named_vals, tree):
    """Port per-leaf values → one vector in the JAX ravel order."""
    return np.concatenate([
        (v.numpy().transpose(2, 3, 1, 0) if v.dim() == 4 else v.numpy()).ravel()
        for _, v in named_vals])


@pytest.mark.parametrize("opt_type", ["sgd", "adam"])
@pytest.mark.parametrize("gscale", [1e-3, 1e3])  # clip off / triggered
@pytest.mark.parametrize("freeze", [False, True])
def test_flat_update_matches_jax(opt_type, gscale, freeze):
    rng = np.random.Generator(np.random.PCG64(0))
    params = _toy_params(rng)
    jtc = JaxTrainConfig(optimizer_type=opt_type)
    factors_j = jax_flat.build_factors(params, {"s": np.zeros(2, np.float32)},
                                       train_bifpn=False)
    flat_j = jnp.asarray(ravel_pytree(params)[0])
    opt_j = jax_flat.init_flat_opt(jtc, factors_j.n_params)

    named = _port_named(params)
    tc = TrainConfig(optimizer_type=opt_type)
    factors = flat_opt.build_factors(named, train_bifpn=False)
    layout = factors.layout
    flat_p = layout.ravel([t for _, t in named])
    opt = flat_opt.init_flat_opt(tc, layout.n)
    lr = 0.01
    for step in range(3):
        g_tree = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * gscale).astype(np.float32), params)
        upd_j, opt_j = jax_flat.flat_update(jtc, factors_j, ravel_pytree(g_tree)[0],
                                            flat_j, opt_j, freeze_backbone=freeze)
        flat_j = flat_j + lr * upd_j
        g = layout.ravel([t for _, t in _port_named(g_tree)])
        upd, opt = flat_opt.flat_update(tc, factors, g, flat_p, opt, freeze_backbone=freeze)
        flat_p = flat_p + lr * upd
        got = _to_jax_order(list(zip(layout.names, layout.views(flat_p))), params)
        np.testing.assert_allclose(got, np.asarray(flat_j), rtol=2e-6, atol=1e-7,
                                   err_msg=f"{opt_type} gscale={gscale} freeze={freeze} "
                                           f"step={step}")
    if freeze:  # the backbone kernel never moved and holds no state
        np.testing.assert_array_equal(layout.views(flat_p)[0].numpy(), named[0][1].numpy())
        state = opt.trace if opt_type == "sgd" else opt.mu
        assert not layout.views(state)[0].any()


def test_flat_ema_matches_jax():
    """The ramp d = decay·(1 − e^(−u/τ)) comes from numpy's float32 exp here
    and XLA's there, which may differ by one float32 ulp of e^(−u/τ) ≈ 1;
    d moves by that much, and each element by that times |ema − new|."""
    rng = np.random.default_rng(3)
    ema = rng.standard_normal(1000).astype(np.float32)
    new = rng.standard_normal(1000).astype(np.float32)
    for updates in (1, 7, 5000):
        got = torch.from_numpy(ema.copy())
        flat_opt.flat_ema(got, torch.from_numpy(new), updates, 0.9999, 2000.0)
        ref = np.asarray(jax_flat.flat_ema(jnp.asarray(ema), jnp.asarray(new),
                                           jnp.asarray(updates, jnp.int32), 0.9999,
                                           2000.0))
        tol = 2e-6 * np.abs(ref) + np.finfo(np.float32).eps * np.abs(ema - new) + 1e-7
        assert (np.abs(got.numpy() - ref) <= tol).all(), updates


HW = (64, 64)


def _trainer(flat_tail, opt="sgd"):
    cfg = ModelConfig(num_classes=1, phi="n", input_shape=HW, train_stem_backend="kernel")
    return Trainer(init_model(cfg, 0, "cpu", train=True),
                   TrainConfig(max_boxes=8, optimizer_type=opt), device="cpu",
                   flat_tail=flat_tail)


def _snapshot(tr):
    st = tr.state
    opt = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
           for k, v in st.opt_state.items()}
    return ({k: v.clone() for k, v in st.params.items()},
            {k: v.clone() for k, v in st.batch_stats.items()},
            {k: v.clone() for k, v in st.ema.items()}, opt, st.ema_updates)


def _assert_states_equal(a, b):
    for what, x, y in zip(("params", "batch_stats", "ema"), a[:3], b[:3]):
        assert x.keys() == y.keys(), what
        for k in x:
            assert torch.equal(x[k], y[k]), (what, k)
    for slot, v in a[3].items():
        if isinstance(v, dict):
            for n in v:
                assert torch.equal(v[n], b[3][slot][n]), (slot, n)
        else:
            assert v == b[3][slot], slot
    assert a[4] == b[4]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_flat_tail_is_bit_equal_to_the_per_tensor_path(opt):
    """Three full steps at 64² (the second in the freeze phase, clipping
    active): losses, parameters, BN statistics, EMA and optimizer state
    equal bit for bit."""
    hb = synthetic_batch(2, HW, 8, 3)
    flat, tree = _trainer(True, opt), _trainer(False, opt)
    assert flat.flat_tail and not tree.flat_tail
    for freeze in (False, True, False):
        lf = flat.train_step(flat.put_batch(*hb), 1e-2, freeze_backbone=freeze)
        lt = tree.train_step(tree.put_batch(*hb), 1e-2, freeze_backbone=freeze)
        assert [float(t) for t in lf] == [float(t) for t in lt]
    _assert_states_equal(_snapshot(flat), _snapshot(tree))


def test_parameters_are_views_of_the_flat_vector():
    tr = _trainer(True)
    flat = tr.flat_params
    for (name, p), v in zip(tr._named, flat_opt.FlatLayout(tr._named).views(flat)):
        assert p.data_ptr() == v.data_ptr(), name
    with torch.no_grad():
        flat.zero_()
    assert all(not p.any() for _, p in tr._named)


def test_state_roundtrip_and_exact_resume():
    """`state` → its setter round-trips exactly (momentum kept), and a
    trainer restored from a saved state continues bit for bit as the
    uninterrupted one."""
    hb = synthetic_batch(2, HW, 8, 4)
    straight = _trainer(True)
    b = straight.put_batch(*hb)
    straight.train_step(b, 1e-2)
    before = _snapshot(straight)
    straight.state = straight.state
    _assert_states_equal(_snapshot(straight), before)
    flat = straight.flat_state  # the momentum survives the round trip
    assert flat.opt.trace.abs().sum() > 0 and flat.ema_updates == 1
    assert flat.flat_params.data_ptr() == straight.flat_params.data_ptr()

    buf = io.BytesIO()
    torch.save(straight.state._asdict(), buf)
    buf.seek(0)
    resumed = _trainer(True)
    resumed.state = TrainState(**torch.load(buf, weights_only=True))
    _assert_states_equal(_snapshot(resumed), before)
    la = straight.train_step(b, 1e-2)
    lb = resumed.train_step(resumed.put_batch(*hb), 1e-2)
    assert float(la.total) == float(lb.total)
    _assert_states_equal(_snapshot(resumed), _snapshot(straight))
