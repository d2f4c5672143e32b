"""The port's single-device train step (dcfa_yolo_tpu_torch/train/trainer.py)
in lockstep with the JAX package's `Trainer`, float32 on the CPU.

All runs start from the same flax variables (carried over by
`models/convert.py::from_jax_variables`) and see the same batch: two
SGD-nesterov steps with weight decay and active gradient clipping, then one
freeze-phase step.  The reference is the JAX trainer with its fused stem
(`train_stem_backend='pallas'`, Pallas interpret mode).  The port runs its
'kernel' stem graph (the wrapper takes the plain version on CPU tensors).

Lockstep: before each step, the port and a second JAX trainer, with the XLA
stem, are loaded with the reference's state (parameters, BN statistics,
optimizer trace, EMA and its counter), so each step is compared from
identical weights.  The XLA-stem run measures the JAX package's own spread
between its two stem graphs.

Tolerances, and why.  Loss per step to rtol 1e-4.  Each parameter leaf's
update within 1e-3 of the leaf's largest reference update, plus two float32
ulps of the leaf's largest value (an update is a difference of two float32
parameters) and float32 eps times the step's largest update (a bias that
feeds a train-mode BN has a zero gradient in exact arithmetic, so its update
is rounding noise).  BN running statistics and the EMA to atol 1e-5.

One exception, shown by `test_first_step_spread_is_one_relu_tie`: in the
first step the two JAX stem graphs disagree beyond 1e-3 on the parameter
leaves of the RGB backbone's stem and `dark2` block, the leaves upstream of
one ReLU.  One pre-ReLU value of `dark2_shuffle.b2_bn3` lies within 2e-5 of
zero, and the fused stem's batch variance, rounded in another order, moves
it across zero: the ReLU routes that value's gradient in one graph and not
in the other.  The port's stem
sums round as the XLA stem's do, so on those leaves (and their EMA) the
port is held to the XLA-stem run, at the same tolerance.

A free-running port trajectory (its own state carried across the three
steps) is held at the third step within 1.5 times the JAX package's own
free-running spread: there the first step's tie has compounded.

    PYTHONPATH=. python tests/test_torch_trainer.py

prints the per-step spreads.  The JAX trainers run once, in a module-scoped
fixture (their jit compiles dominate the file's time).
"""

from __future__ import annotations

if __name__ == "__main__":  # the CPU set-up of tests/conftest.py
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfa_yolo_tpu.config import ModelConfig as JaxModelConfig
from dcfa_yolo_tpu.config import TrainConfig as JaxTrainConfig
from dcfa_yolo_tpu.models.yolo import DCFAYolo as JaxDCFAYolo
from dcfa_yolo_tpu.parallel.mesh import make_mesh, replicated
from dcfa_yolo_tpu.train.init_weights import reference_weights_init as jax_init
from dcfa_yolo_tpu.train.trainer import Trainer as JaxTrainer
from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
from dcfa_yolo_tpu_torch.models.convert import from_jax_variables
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo
from dcfa_yolo_tpu_torch.ops import cuda_stem_train
from dcfa_yolo_tpu_torch.train.loss import pad_targets
from dcfa_yolo_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

HW = (64, 64)
B = 2
STEPS = ((1e-2, False), (1e-2, False), (1e-2, True))  # (lr, freeze)
TIE_MODULE = "backbone_rgb.dark2_shuffle.b2_bn3"


def _batch():
    rng = np.random.default_rng(7)
    rgb = rng.random((B, *HW, 3), np.float32)
    nir = rng.random((B, *HW, 3), np.float32)
    labels = np.array([[0, 0, 0.50, 0.50, 0.40, 0.40],
                       [0, 0, 0.25, 0.30, 0.20, 0.30],
                       [1, 0, 0.60, 0.40, 0.50, 0.30]], np.float32)
    return (rgb, nir) + pad_targets(labels, B, 4, HW)


def _np_tree(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _jax_trainer(stem, variables, batch):
    cfg = JaxModelConfig(num_classes=1, phi="n", input_shape=HW,
                         train_stem_backend=stem)
    jt = JaxTrainer(JaxDCFAYolo(cfg), variables,
                    JaxTrainConfig(max_boxes=4), mesh=make_mesh(1))
    jb = jt.put_batch(*batch)
    # commit the initial state to the replicated sharding every step's
    # output has, so the first and later steps share one compiled program
    jt._state = jax.device_put(jt._state, replicated(jt.mesh))
    return jt, jb


def _jax_snap(jt, loss=None):
    """A JAX trainer's state as numpy state_dicts under the port's names."""
    st = jt.state
    # the SGD chain's leaves are the trace tree, in the params' flatten order
    trace = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(st.params),
                                         jax.tree_util.tree_leaves(st.opt_state))
    return dict(loss=loss, raw=_np_tree(from_jax_variables(jt.raw_variables())),
                ema=_np_tree(from_jax_variables(jt.ema_variables())),
                trace=_np_tree(from_jax_variables({"params": trace})),
                updates=int(st.ema.updates))


def _port_snap(pt, loss):
    return dict(loss=loss, raw=_np_tree(pt.raw_variables()),
                ema=_np_tree(pt.ema_variables()),
                trace=_np_tree(pt.state.opt_state["trace"]))


def _load_port(pt, snap):
    """Put a JAX snapshot into the port trainer: weights, BN statistics,
    optimizer trace and EMA."""
    pt.model.load_state_dict({k: torch.from_numpy(v) for k, v in snap["raw"].items()},
                             strict=True)
    with torch.no_grad():
        for n, t in zip(pt.optimizer.names, pt.optimizer.trace):
            t.copy_(torch.from_numpy(snap["trace"][n]))
        for k, v in pt.ema.variables.items():
            v.copy_(torch.from_numpy(snap["ema"][k]))
    pt.ema.updates = snap["updates"]


def _port_trainer(start):
    model = DCFAYolo(ModelConfig(num_classes=1, phi="n", input_shape=HW,
                                 train_stem_backend="kernel"))
    model.load_state_dict(start, strict=True)
    return Trainer(model, TrainConfig(max_boxes=4), device="cpu")


def _initial_variables():
    """The flax tree from eval_shape (no init compile), filled as flax's
    initializers fill what the reference init leaves alone (BiFPN w = 1,
    running mean 0 and var 1), then the reference init with seed 1."""
    cfg = JaxModelConfig(num_classes=1, phi="n", input_shape=HW)
    dummy = jnp.zeros((B, *HW, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JaxDCFAYolo(cfg).init(
        jax.random.PRNGKey(0), dummy, dummy, train=False))
    fill = lambda path, x: (np.ones if jax.tree_util.keystr(path).endswith(
        ("['w']", "['var']")) else np.zeros)(x.shape, np.float32)
    variables = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    variables["params"] = jax_init(variables["params"], seed=1)
    return variables


def _lockstep_runs():
    variables = _initial_variables()
    start = from_jax_variables(variables)
    batch = _batch()

    # the reference trajectory; ref[k] is its state before step k
    jp, jbp = _jax_trainer("pallas", variables, batch)
    ref, held = [_jax_snap(jp)], []
    for lr, freeze in STEPS:
        held.append(jax.tree_util.tree_map(np.asarray, jp._state))
        lb = jp.train_step(jbp, lr, freeze_backbone=freeze)
        ref.append(_jax_snap(jp, float(lb.total)))

    # the XLA stem: free-running first, then each step from ref[k]
    jx, jbx = _jax_trainer("xla", variables, batch)
    xla_free = []
    for lr, freeze in STEPS:
        lb = jx.train_step(jbx, lr, freeze_backbone=freeze)
        xla_free.append(_jax_snap(jx, float(lb.total)))
    xla_lock = []
    for (lr, freeze), state in zip(STEPS, held):
        jx._state = jax.device_put(state, replicated(jx.mesh))
        lb = jx.train_step(jbx, lr, freeze_backbone=freeze)
        xla_lock.append(_jax_snap(jx, float(lb.total)))

    pt = _port_trainer(start)
    pb = pt.put_batch(*batch)
    port_free = []
    for lr, freeze in STEPS:
        lb = pt.train_step(pb, lr, freeze_backbone=freeze)
        port_free.append(_port_snap(pt, float(lb.total)))
    lock = _port_trainer(start)
    port_lock = []
    for (lr, freeze), snap in zip(STEPS, ref):
        _load_port(lock, snap)
        lb = lock.train_step(pb, lr, freeze_backbone=freeze)
        port_lock.append(_port_snap(lock, float(lb.total)))
    return dict(start=_np_tree(start), batch=batch, ref=ref, xla_free=xla_free,
                xla_lock=xla_lock, port_free=port_free, port_lock=port_lock,
                port=pt, names=[n for n, _ in pt.model.named_parameters()])


@pytest.fixture(scope="module")
def runs():
    return _lockstep_runs()


def _leaf_check(after, ref_after, before, names):
    """{leaf: (error, tolerance)} of one step's update against the
    reference's, by the module docstring's rule."""
    noise = np.finfo(np.float32).eps * max(
        np.abs(ref_after[n] - before[n]).max() for n in names)
    out = {}
    for n in names:
        dj, dp = ref_after[n] - before[n], after[n] - before[n]
        ulp = np.spacing(np.float32(np.abs(before[n]).max()))
        out[n] = (np.abs(dp - dj).max(), 1e-3 * np.abs(dj).max() + 2 * ulp + noise)
    return out


def _tie_leaves(r, step):
    """Leaves on which the JAX package's two stem graphs disagree beyond
    the per-leaf tolerance at this step (from the same state)."""
    chk = _leaf_check(r["xla_lock"][step]["raw"], r["ref"][step + 1]["raw"],
                      r["ref"][step]["raw"], r["names"])
    return {n for n, (err, tol) in chk.items() if err > tol}


def _rel_l2(after, ref_after, before, names):
    d = np.concatenate([(after[n] - before[n]).ravel() for n in names])
    d_ref = np.concatenate([(ref_after[n] - before[n]).ravel() for n in names])
    return np.linalg.norm(d - d_ref) / np.linalg.norm(d_ref)


def test_port_graph_is_the_kernel_graph(runs):
    stem = runs["port"].model.backbone_rgb.stem
    assert cuda_stem_train.resolve_train_stem(
        stem.backend, 16, HW, torch.float32, torch.device("cpu")) == "kernel"
    assert runs["port"].ema.updates == len(STEPS)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_loss_per_step(runs, step):
    np.testing.assert_allclose(runs["port_lock"][step]["loss"],
                               runs["ref"][step + 1]["loss"], rtol=1e-4)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_update_leaf_by_leaf(runs, step):
    """Each leaf's update from the reference state against the fused-stem
    run's; on the first step's tie leaves, against the XLA-stem run's."""
    names, before = runs["names"], runs["ref"][step]["raw"]
    ties = _tie_leaves(runs, step)
    if step > 0:
        assert not ties, sorted(ties)
    port = runs["port_lock"][step]["raw"]
    to_ref = _leaf_check(port, runs["ref"][step + 1]["raw"], before, names)
    to_xla = _leaf_check(port, runs["xla_lock"][step]["raw"], before, names)
    for n in names:
        err, tol = (to_xla if n in ties else to_ref)[n]
        assert err <= tol, (n, err, tol)


def _tie_value(r):
    """The port's smallest pre-ReLU value of TIE_MODULE in the first step's
    forward, and its channel's standard deviation."""
    model = _port_trainer({k: torch.from_numpy(v) for k, v in r["start"].items()}).model
    seen = {}
    model.get_submodule(TIE_MODULE).register_forward_hook(
        lambda mod, args, out: seen.setdefault("out", out.detach()))
    with torch.no_grad():
        model.train_feats(*(torch.from_numpy(a) for a in r["batch"][:2]))
    pre_relu = seen["out"]
    at = np.unravel_index(int(pre_relu.abs().argmin()), tuple(pre_relu.shape))
    return float(pre_relu[at].abs()), float(pre_relu[:, at[1]].std())


def test_first_step_spread_is_one_relu_tie(runs):
    """The JAX package's two stem graphs part at the first step only on
    the RGB backbone's stem and dark2 block, and that block holds a ReLU
    input within 2e-5 of zero in a channel of spread about 1."""
    upstream = ("backbone_rgb.stem.", "backbone_rgb.dark2_")
    ties = _tie_leaves(runs, 0)
    assert ties and all(n.startswith(upstream) for n in ties), sorted(
        n for n in ties if not n.startswith(upstream))
    value, spread = _tie_value(runs)
    assert value < 2e-5 and spread > 0.5, (value, spread)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_running_stats_and_ema(runs, step):
    """BN running statistics and the EMA after each lockstep step, atol
    1e-5 (the EMA of the first step's tie leaves against the XLA-stem
    run)."""
    params = set(runs["names"])
    ties = _tie_leaves(runs, step)
    port, ref, xla = runs["port_lock"][step], runs["ref"][step + 1], runs["xla_lock"][step]
    for k in port["raw"]:
        if k not in params:
            np.testing.assert_allclose(port["raw"][k], ref["raw"][k], rtol=0,
                                       atol=1e-5, err_msg=k)
    for k in port["ema"]:
        np.testing.assert_allclose(port["ema"][k], (xla if k in ties else ref)["ema"][k],
                                   rtol=0, atol=1e-5, err_msg=k)
    assert ref["updates"] == step + 1


def test_free_running_third_step_within_the_jax_spread(runs):
    """The port's own three-step trajectory: losses to rtol 1e-3 and the
    third update within 1.5 times the JAX package's free-running spread
    between its two stem graphs (relative L2 over all parameters)."""
    names, ref = runs["names"], runs["ref"]
    port, xla = runs["port_free"], runs["xla_free"]
    for step in range(len(STEPS)):
        np.testing.assert_allclose(port[step]["loss"], ref[step + 1]["loss"], rtol=1e-3)
    spread = _rel_l2(xla[2]["raw"], ref[3]["raw"], xla[1]["raw"], names)
    ours = _rel_l2(port[2]["raw"], ref[3]["raw"], port[1]["raw"], names)
    assert ours <= 1.5 * spread + 1e-3, (ours, spread)


def test_freeze_step_holds_backbones(runs):
    """The freeze step leaves backbone parameters exactly where they were,
    with a zero optimizer state, as the JAX trainer does, while their BN
    statistics and the rest of the model still move."""
    before, after = runs["ref"][2]["raw"], runs["port_lock"][2]["raw"]
    ref_after = runs["ref"][3]["raw"]
    trace = runs["port_lock"][2]["trace"]
    for k in trace:
        if k.startswith(("backbone_rgb.", "backbone_nir.")):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
            np.testing.assert_array_equal(ref_after[k], before[k], err_msg=k)
            assert not trace[k].any(), k
    assert not np.array_equal(after["cv3_0_2.weight"], before["cv3_0_2.weight"])
    stat = "backbone_rgb.stem.bn.running_mean"
    assert not np.array_equal(after[stat], before[stat])


def _report(r):
    names = r["names"]
    print("step | loss: fused-stem JAX, XLA-stem JAX, port (lockstep) | relative L2 "
          "of the update against the fused-stem run's: XLA-stem, port (lockstep); "
          "XLA-stem, port (free-running) | tie leaves")
    for k in range(len(STEPS)):
        before, ref = r["ref"][k]["raw"], r["ref"][k + 1]["raw"]
        free_before = (lambda run: r["start"] if k == 0 else run[k - 1]["raw"])
        print(f"{k + 1} | {r['ref'][k + 1]['loss']:.7f}, {r['xla_lock'][k]['loss']:.7f}, "
              f"{r['port_lock'][k]['loss']:.7f} | "
              f"{_rel_l2(r['xla_lock'][k]['raw'], ref, before, names):.3e}, "
              f"{_rel_l2(r['port_lock'][k]['raw'], ref, before, names):.3e}; "
              f"{_rel_l2(r['xla_free'][k]['raw'], ref, free_before(r['xla_free']), names):.3e}, "
              f"{_rel_l2(r['port_free'][k]['raw'], ref, free_before(r['port_free']), names):.3e} | "
              f"{len(_tie_leaves(r, k))}")
    ties = _tie_leaves(r, 0)
    chk = _leaf_check(r["xla_lock"][0]["raw"], r["ref"][1]["raw"], r["ref"][0]["raw"], names)
    worst = max(chk[n][0] / np.abs(r["ref"][1]["raw"][n] - r["ref"][0]["raw"][n]).max()
                for n in ties)
    print(f"first-step tie leaves ({len(ties)}; the XLA-stem update off by up to "
          f"{worst:.3e} of the leaf's largest):", sorted(ties))
    print("smallest |pre-ReLU| of %s, first step: %.3e (channel std %.4f)"
          % ((TIE_MODULE,) + _tie_value(r)))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _report(_lockstep_runs())
