"""The port's flat optimizer and EMA tail (dcfa_yolo_tpu_torch/train/flat_opt.py)
against the JAX package's `train/flat_opt.py`, and the trainer's tail
against the optax chain and the JAX `update_ema`, on the CPU.

Tolerances: one flat step against the JAX flat step to rtol 2e-6 / atol
1e-7, as tests/test_flat_opt.py holds the JAX flat tail against optax (the
same float32 formulas; the bias corrections' powers round in numpy here and
in XLA there).  The trainer's steps against optax and `update_ema` on its
own flat gradients: rtol 1e-4 / atol 1e-5, as tests/test_flat_opt.py holds
the JAX flat-tail trainer against its tree trainer (two programs that
reduce in other orders: the clip's global norm over 2.4 M entries, which
Adam's normalised step amplifies where a gradient nearly cancels its weight
decay), here on the moves of the parameters and the EMA from the start,
and on the optimizer state's flat vectors with the atol scaled to their
largest entry.  The state round trip and resume: bit for bit.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
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


def _trainer(opt="sgd"):
    cfg = ModelConfig(num_classes=1, phi="n", input_shape=HW, train_stem_backend="kernel")
    return Trainer(init_model(cfg, 0, "cpu", train=True),
                   TrainConfig(max_boxes=8, optimizer_type=opt), device="cpu")


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


def _jax_paths(named):
    """Each port parameter's path in the tree optax's masks read: the port
    name's scopes, with a 4-D `weight` as `kernel` (decayed, as
    `optim.py::decay_mask` takes it) and every other leaf by its own name."""
    return [tuple(n.split(".")[:-1]) + (
        "kernel" if n.endswith(".weight") and t.dim() == 4 else n.rsplit(".", 1)[-1],)
        for n, t in named]


def _tree_of(paths, arrays):
    tree = {}
    for path, a in zip(paths, arrays):
        node = tree
        for s in path[:-1]:
            node = node.setdefault(s, {})
        node[path[-1]] = jnp.asarray(a)
    return tree


def _leaf(tree, path):
    for s in path:
        tree = tree[s]
    return np.asarray(tree)


def _opt_slots(state):
    """The optax chain's momentum trace, or Adam's mu and nu, by name."""
    for s in jax.tree_util.tree_leaves(state, is_leaf=lambda x: hasattr(x, "_fields")):
        if hasattr(s, "trace"):
            return {"trace": s.trace}
        if hasattr(s, "mu"):
            return {"mu": s.mu, "nu": s.nu}
    raise AssertionError(f"no optimizer slots in {state}")


def _close(got, ref, what, atol=1e-5):
    """The JAX package's limits for two trainers' states (tests/test_flat_opt.py:
    rtol 1e-4, atol 1e-5)."""
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol, err_msg=what)


# (learning rates, freeze phase) a step: three steps at lr 1e-2 with the
# second frozen; five with a new lr each and the freeze toggled
TAIL_RUNS = {"clip_freeze": ((1e-2,) * 3, (False, True, False)),
             "new_lr": ((1e-2, 3e-3, 2.5e-2, 7e-4, 1.5e-2), (False, True, True, False, False))}


@pytest.mark.parametrize("run", sorted(TAIL_RUNS))
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_trainer_tail_matches_optax_and_jax_ema(opt, run):
    """Whole steps of the trainer at 64²; each step's flat gradient
    (`step_with_grad`) goes through the optax chain of `build_optimizer`
    with the JAX trainer's freeze masking, and the new state through JAX's
    `update_ema`: the trainer's parameters and EMA (as their moves from the
    start) and its optimizer state equal theirs (`_close`)."""
    from dcfa_yolo_tpu.train.ema import init_ema, update_ema
    from dcfa_yolo_tpu.train.optim import build_optimizer, frozen_backbone_mask
    from dcfa_yolo_tpu.train.trainer import _mask_frozen_opt_state

    lrs, freezes = TAIL_RUNS[run]
    tr = _trainer(opt)
    clip = tr.tc.grad_clip_norm
    layout = tr._p_layout
    paths = _jax_paths(tr._named)
    host = lambda vec: [v.numpy().copy() for v in layout.views(vec)]
    params = start = _tree_of(paths, host(tr.flat_params))
    tx = build_optimizer(JaxTrainConfig(optimizer_type=opt, grad_clip_norm=clip), params)
    state = tx.init(params)
    mask = frozen_backbone_mask(params)
    ema_names = list(tr.ema.variables)
    ema0 = {k: v.numpy().copy() for k, v in tr.ema.variables.items()}
    ema = init_ema(ema0)
    norms = []
    for step, (lr, freeze) in enumerate(zip(lrs, freezes)):
        _, g = tr.step_with_grad(tr.put_batch(*synthetic_batch(2, HW, 8, 30 + step)), lr,
                                 freeze_backbone=freeze)
        g = _tree_of(paths, host(g))
        if freeze:
            g = jax.tree_util.tree_map(lambda x, m: jnp.zeros_like(x) if m else x, g, mask)
        norms.append(float(optax.global_norm(g)))
        upd, state = tx.update(g, state, params)
        if freeze:
            upd = jax.tree_util.tree_map(lambda u, m: jnp.zeros_like(u) if m else u, upd, mask)
            state = _mask_frozen_opt_state(tx, state, mask)
        params = jax.tree_util.tree_map(lambda p, u: p + u * lr, params, upd)
        live = dict(zip(layout.names, (_leaf(params, p) for p in paths)))
        live.update({k: v.numpy() for k, v in tr.state.batch_stats.items()})
        ema = update_ema(ema, {k: live[k] for k in ema_names}, tr.tc.ema_decay, tr.tc.ema_tau)
    assert min(norms) > clip  # the clip scaled every step
    got = tr.state
    for name, path in zip(layout.names, paths):
        p0 = _leaf(start, path)
        _close(got.params[name].numpy() - p0, _leaf(params, path) - p0, name)
    for k, v in _opt_slots(state).items():  # Adam's nu lives near 1e-11: atol to scale
        ref = np.concatenate([_leaf(v, p).ravel() for p in paths])
        _close(getattr(tr.optimizer.opt, k).numpy(), ref, k, 1e-5 * np.abs(ref).max())
    assert tr.ema.updates == int(ema.updates) == len(lrs)
    for k in ema_names:
        _close(got.ema[k].numpy() - ema0[k], np.asarray(ema.variables[k]) - ema0[k], k)


def test_parameters_are_views_of_the_flat_vector():
    tr = _trainer()
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
    straight = _trainer()
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
    resumed = _trainer()
    resumed.state = TrainState(**torch.load(buf, weights_only=True))
    _assert_states_equal(_snapshot(resumed), before)
    la = straight.train_step(b, 1e-2)
    lb = resumed.train_step(resumed.put_batch(*hb), 1e-2)
    assert float(la.total) == float(lb.total)
    _assert_states_equal(_snapshot(resumed), _snapshot(straight))
