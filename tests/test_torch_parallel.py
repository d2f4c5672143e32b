"""Data-parallel training and serving of the port (dcfa_yolo_tpu_torch/parallel/,
the trainer's step modes, kernel C's sums across ranks) on 2 gloo ranks on
the CPU, against the JAX package and the port's own one-process runs.

The ranks are spawned processes joined by a `file://` store under the
test's temporary directory (`parallel/mesh.py::run_ranks`, one thread
each); one spawn runs every rank-side check of the module
(`parallel/mesh.py::run_calls`).  They mirror tests/test_fused_multidevice.py
(the fused check's global moments, n ranks ≡ 1, split ≡ fused on equal
per-rank batches), tests/test_train_stem.py:168-195 (kernel C under
shard_map), tests/test_serving_sharded.py and the JAX Trainer's split mode
on `make_mesh(2)`.

Tolerances: the conv-free check at tests/test_fused_multidevice.py's (rtol
1e-5 / atol 1e-7; BN moments rtol 1e-5 / atol 1e-6); kernel C at
tests/test_train_stem.py's float32 ones (y rtol 1e-5 / atol 1e-5, mean atol
1e-6, var atol 1e-5, gradients rtol 1e-4 / atol 1e-4 of the largest);
the full model at tests/test_torch_trainer.py's (loss rtol 1e-4, each
parameter leaf's update within 1e-3 of the reference's largest plus two
ulps and the step's rounding noise, BN statistics and EMA atol 1e-5);
serving: integers exact, floats 1e-6.  After every step the parameters
are equal on both ranks.
"""

from __future__ import annotations

import copy
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from dcfa_yolo_tpu.config import ModelConfig as JaxModelConfig
from dcfa_yolo_tpu.config import TrainConfig as JaxTrainConfig
from dcfa_yolo_tpu.models.yolo import DCFAYolo as JaxDCFAYolo
from dcfa_yolo_tpu.ops.pallas_stem_train import fused_train_stem as jax_stem
from dcfa_yolo_tpu.parallel import fused_check as jax_check
from dcfa_yolo_tpu.parallel.mesh import make_mesh
from dcfa_yolo_tpu.train.init_weights import reference_weights_init as jax_init
from dcfa_yolo_tpu.train.trainer import Trainer as JaxTrainer
from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
from dcfa_yolo_tpu_torch.data import voc
from dcfa_yolo_tpu_torch.data.loader import BatchLoader, PairedDetectionDataset
from dcfa_yolo_tpu_torch.infer.pipeline import detect_batch
from dcfa_yolo_tpu_torch.models.convert import from_jax_variables
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo, init_model
from dcfa_yolo_tpu_torch.ops.cuda_stem_train import fused_train_stem
from dcfa_yolo_tpu_torch.parallel import dryrun, fused_check, serve
from dcfa_yolo_tpu_torch.parallel.mesh import (all_reduce_mean, all_reduce_sum,
                                               run_calls, run_ranks, shard_batch)
from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset
from dcfa_yolo_tpu_torch.train.__main__ import run as train_cli
from dcfa_yolo_tpu_torch.train.loss import YoloLoss
from dcfa_yolo_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

# the full-model steps: 64², a global batch of 8 (4 a rank).  At the dry
# run's 32² the deepest maps are 1×1 and local BN there normalises 2-8
# values: the JAX package's own two stem graphs then part beyond
# tests/test_torch_trainer.py's per-leaf limits on 14 (b16) to 190 (b8)
# leaves of the split step; at 64² b8 on none
HW = (64, 64)
B = 8
EPS = 1e-5
SERVE_KW = dict(conf_thres=0.3, iou_thres=0.5, letterbox=True, max_det=20,
                pre_nms_topk=64)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


@pytest.fixture(scope="module")
def inputs():
    """Everything both sides see: the conv-free check's variables and batch,
    kernel C's inputs, the full model's initial variables and batch, and
    the serving pairs."""
    tiny_model, tiny_vars, tiny_batch = jax_check.setup()
    tiny_batch = tuple(np.asarray(x) for x in tiny_batch)
    dup = tuple(np.concatenate([x[:4]] * 2) for x in tiny_batch)

    rng = np.random.Generator(np.random.PCG64(4))
    stem = dict(x=rng.standard_normal((4, 16, 18, 3)).astype(np.float32),
                k=(rng.standard_normal((3, 3, 3, 16)) * 0.3).astype(np.float32),
                gamma=(rng.standard_normal(16)).astype(np.float32),
                beta=(rng.standard_normal(16) * 0.1).astype(np.float32),
                gy=rng.standard_normal((4, 8, 9, 16)).astype(np.float32))

    # the flax tree from eval_shape (no init compile), filled as flax's
    # initializers fill what the reference init leaves alone, then the
    # reference init (tests/test_torch_trainer.py's recipe)
    cfg = JaxModelConfig(num_classes=1, phi="n", input_shape=HW)
    dummy = jnp.zeros((B, *HW, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JaxDCFAYolo(cfg).init(
        jax.random.PRNGKey(0), dummy, dummy, train=False))
    fill = lambda path, x: (np.ones if jax.tree_util.keystr(path).endswith(
        ("['w']", "['var']")) else np.zeros)(x.shape, np.float32)
    variables = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    variables["params"] = jax_init(variables["params"], seed=1)

    rng = np.random.Generator(np.random.PCG64(3))
    serve_in = (rng.integers(0, 255, (4, 48, 72, 3), dtype=np.uint8),
                rng.integers(0, 255, (4, 48, 72, 3), dtype=np.uint8),
                np.tile([48.0, 72.0], (4, 1)).astype(np.float32))
    return dict(tiny_vars=tiny_vars, tiny_batch=tiny_batch, dup=dup, stem=stem,
                variables=variables, batch=dryrun.dry_batch(B, HW), serve=serve_in)


def _tiny_sd(inputs):
    return {k: v.numpy() for k, v in from_jax_variables(inputs["tiny_vars"]).items()}


def _model_spec(inputs, mode, batch=None):
    sd = {k: v.numpy() for k, v in from_jax_variables(inputs["variables"]).items()}
    return dict(cfg=dict(num_classes=1, phi="n", input_shape=HW,
                         train_stem_backend="kernel"),
                state_dict=sd, batch=inputs["batch"] if batch is None else batch,
                step_mode=mode, tc=dict(max_boxes=4), steps=2, lr=1e-2, eval=True)


def _half_empty(batch):
    """The batch with no ground truth on the second rank's images: that
    rank's target scores sum to 0, under the normaliser's clamp of 1."""
    gt_mask = batch[4].copy()
    gt_mask[len(gt_mask) // 2:] = 0
    return (*batch[:4], gt_mask)


def _stem_spec(inputs):
    s = inputs["stem"]
    return dict(x=s["x"], gy=s["gy"], kernel=s["k"].transpose(3, 2, 0, 1),
                gamma=s["gamma"], beta=s["beta"], eps=EPS)


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    """Every rank-side check, on 2 gloo ranks in one spawn, started in a
    thread so that the ranks run while this process compiles the JAX
    references (`ranks` waits for them)."""
    calls = [(fused_check.rank_checks, (_tiny_sd(inputs), inputs["tiny_batch"],
                                        inputs["dup"])),
             (dryrun.stem_rank, (_stem_spec(inputs),)),
             (dryrun.train_rank, (_model_spec(inputs, "split"),)),
             (dryrun.train_rank, (_model_spec(inputs, "fused"),)),
             (dryrun.train_rank, (dict(_model_spec(inputs, "fused", _half_empty(
                 inputs["batch"])), steps=1, eval=False),)),
             (serve.serve_rank, (dict(cfg=dict(num_classes=2, phi="n", input_shape=(64, 64)),
                                      seed=0, inputs=inputs["serve"], kw=SERVE_KW),))]
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, run_calls, 2, (calls,),
                          store_dir=str(tmp_path_factory.mktemp("store")))


@pytest.fixture(scope="module")
def ranks(spawned, jax_runs):
    names = ("check", "stem", "split", "fused", "fused_half_empty", "serve")
    return [dict(zip(names, r)) for r in spawned.result()]


@pytest.fixture(scope="module")
def jax_runs(inputs, spawned):
    """The JAX Trainer's split step on make_mesh(2) and its fused step on
    one device, two steps each from the same variables and batch (one
    compile a mode)."""
    out = {}
    cfg = JaxModelConfig(num_classes=1, phi="n", input_shape=HW,
                         train_stem_backend="pallas")
    for mode, n in (("split", 2), ("fused", 1)):
        jt = JaxTrainer(JaxDCFAYolo(cfg), _np_tree(inputs["variables"]),
                        JaxTrainConfig(max_boxes=4), mesh=make_mesh(n), step_mode=mode)
        jb = jt.put_batch(*inputs["batch"])
        losses = [float(jt.train_step(jb, 1e-2).total)]
        raw = {k: v.numpy() for k, v in from_jax_variables(_np_tree(jt.raw_variables())).items()}
        ema = {k: v.numpy() for k, v in from_jax_variables(_np_tree(jt.ema_variables())).items()}
        losses.append(float(jt.train_step(jb, 1e-2).total))
        out[mode] = dict(losses=losses, raw=raw, ema=ema)
    return out


def _one_process(inputs, mode="fused", batch=None):
    """The port's one-process trainer on the global batch, two steps."""
    spec = _model_spec(inputs, mode, batch)
    model = DCFAYolo(ModelConfig(**spec["cfg"]))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in spec["state_dict"].items()})
    tr = Trainer(model, TrainConfig(max_boxes=4), device="cpu")
    b = tr.put_batch(*spec["batch"])
    losses = [float(tr.train_step(b, 1e-2).total)]
    st = tr.state
    np_ = lambda d: {k: v.detach().numpy().copy() for k, v in d.items()}
    out = dict(params=np_(st.params), batch_stats=np_(st.batch_stats), ema=np_(st.ema))
    losses.append(float(tr.train_step(b, 1e-2).total))
    return dict(out, losses=losses)


def _eval_reference(got, batch, mode):
    """The validation loss on a rank's EMA weights, computed here: the
    criterion on each rank's half averaged (split), or on the whole batch,
    the global normaliser (fused)."""
    model = DCFAYolo(ModelConfig(num_classes=1, phi="n", input_shape=HW)).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in got["ema"].items()})
    crit = YoloLoss(model.cfg, TrainConfig(max_boxes=4))
    parts = [batch] if mode == "fused" else [tuple(x[:B // 2] for x in batch),
                                             tuple(x[B // 2:] for x in batch)]
    with torch.no_grad():
        losses = [float(crit(model(*(torch.from_numpy(a) for a in p[:2])).feats,
                             *(torch.from_numpy(a) for a in p[2:5])).total) for p in parts]
    return float(np.mean(losses))


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_eval_step_reduces_as_its_mode(ranks, inputs, mode):
    """`eval_step` on the EMA weights over 2 ranks: split averages the ranks'
    losses, fused normalises by the global batch (`trainer.py:418-440`)."""
    for r in ranks:
        np.testing.assert_allclose(r[mode]["eval"][0],
                                   _eval_reference(r[mode], inputs["batch"], mode),
                                   rtol=1e-4)


@pytest.fixture(scope="module")
def one(inputs):
    return _one_process(inputs)


# -- the conv-free fused check ---------------------------------------------
def _assert_trees(a, b, rtol=1e-5, atol=1e-7):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("which", ["fused", "fused_flat"])
def test_fused_check_matches_jax_on_two_devices(ranks, inputs, which):
    """The port's fused step over 2 ranks (per-tensor and flat tail) against
    the JAX `run_fused` / `run_fused_flat` on a 2-device mesh."""
    jmodel, jvars, jbatch = jax_check.setup()
    ref_state, ref_loss = (jax_check.run_fused if which == "fused"
                           else jax_check.run_fused_flat)(jmodel, jvars, jbatch, n_dev=2)
    ref = from_jax_variables({"params": ref_state.params if which == "fused"
                              else ref_state["params"],
                              "batch_stats": ref_state.batch_stats if which == "fused"
                              else ref_state["batch_stats"]})
    for r in ranks:
        state, loss = r["check"][which]
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
        got = {**state["params"], **state["batch_stats"]}
        _assert_trees(got, {k: v.numpy() for k, v in ref.items()})


def test_fused_check_bn_moments_are_global(ranks, inputs):
    """The running mean and var after one fused step over 2 ranks are those
    of the global batch's moments (Bessel over n = 8); the half-batch
    moments differ."""
    model, _ = fused_check.setup()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in _tiny_sd(inputs).items()})
    mean, var = fused_check.global_moments(model, inputs["tiny_batch"])
    half, _ = fused_check.global_moments(model, tuple(x[:4] for x in inputs["tiny_batch"]))
    for r in ranks:
        stats = r["check"]["fused_flat"][0]["batch_stats"]
        np.testing.assert_allclose(stats["bn.running_mean"], 0.1 * mean, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(stats["bn.running_var"], 0.9 + 0.1 * var * 8 / 7,
                                   rtol=1e-5, atol=1e-6)
        assert not np.allclose(0.1 * half, stats["bn.running_mean"], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("which", ["fused", "fused_flat"])
def test_fused_check_two_ranks_equal_one(ranks, inputs, which):
    model, _ = fused_check.setup()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in _tiny_sd(inputs).items()})
    run = fused_check.run_fused if which == "fused" else fused_check.run_fused_flat
    one_state, one_loss = run(model, inputs["tiny_batch"])
    for r in ranks:
        state, loss = r["check"][which]
        np.testing.assert_allclose(loss, one_loss, rtol=1e-6)
        for coll in ("params", "batch_stats"):
            _assert_trees(state[coll], one_state[coll])
    assert all(np.array_equal(ranks[0]["check"][which][0]["params"][k],
                              ranks[1]["check"][which][0]["params"][k])
               for k in one_state["params"])


def test_split_equals_fused_on_equal_rank_batches(ranks):
    """With equal per-rank batches local BN is global BN: split and fused
    agree on the loss, the parameters and the running mean (the running
    var's Bessel factor counts 4 in split and 8 in fused, by design)."""
    for r in ranks:
        (sf, lf), (ss, ls) = r["check"]["dup_fused"], r["check"]["dup_split"]
        np.testing.assert_allclose(lf, ls, rtol=1e-6)
        _assert_trees(sf["params"], ss["params"])
        np.testing.assert_allclose(sf["batch_stats"]["bn.running_mean"],
                                   ss["batch_stats"]["bn.running_mean"], rtol=1e-5, atol=1e-7)


# -- kernel C's plain twin across ranks -----------------------------------
def test_stem_across_ranks_matches_the_one_process_call(ranks, inputs):
    """y (each rank's half), mean, var and the gradients (x per half;
    kernel, gamma, beta summed over the ranks) against one call on the
    whole batch."""
    spec = _stem_spec(inputs)
    x = torch.from_numpy(spec["x"]).requires_grad_(True)
    params = [torch.from_numpy(np.asarray(spec[k])).requires_grad_(True)
              for k in ("kernel", "gamma", "beta")]
    y, mean, var = fused_train_stem(x, *params, EPS)
    grads = torch.autograd.grad(y, [x, *params], torch.from_numpy(spec["gy"]))
    got = [r["stem"] for r in ranks]
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]), y.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for g in got:
        assert g["launches"] == 0  # the CPU takes the plain version
        np.testing.assert_allclose(g["mean"], mean.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(g["var"], var.detach().numpy(), atol=1e-5)
    parts = {"x": np.concatenate([g["d_x"] for g in got])}
    parts.update({k: got[0][f"d_{k}"] + got[1][f"d_{k}"] for k in ("kernel", "gamma", "beta")})
    for k, ref in zip(("x", "kernel", "gamma", "beta"), grads):
        ref = ref.numpy()
        np.testing.assert_allclose(parts[k], ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)


@pytest.mark.parametrize("sizes", [(2, 0), (3, 1)], ids=["empty", "unequal"])
def test_stem_across_ranks_refuses_uneven_batches(inputs, tmp_path, sizes):
    """An empty or unequal local batch raises on every rank (none is left
    waiting in a collective), as a JAX sharding cannot make one."""
    spec = dict(_stem_spec(inputs), sizes=sizes)
    with pytest.raises(RuntimeError, match="equal, non-empty local batches"):
        run_ranks(dryrun.stem_rank, 2, (spec,), store_dir=str(tmp_path), timeout_s=60)


def test_stem_across_ranks_matches_jax_shard_map(ranks, inputs):
    """Forward against JAX `fused_train_stem(..., axis_name)` under
    shard_map on a 2-device mesh (interpret mode), and the gradients
    against the JAX stem's on the whole batch."""
    s = inputs["stem"]
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    y_j, m_j, v_j = jax.jit(shard_map(
        lambda xs, k, g, b: jax_stem(xs, k, g, b, EPS, "dp", True), mesh=mesh,
        in_specs=(P("dp"), P(), P(), P()), out_specs=(P("dp"), P(), P()),
        check_vma=False))(s["x"], s["k"], s["gamma"], s["beta"])
    got = [r["stem"] for r in ranks]
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    for g in got:
        np.testing.assert_allclose(g["mean"], np.asarray(m_j), atol=1e-6)
        np.testing.assert_allclose(g["var"], np.asarray(v_j), atol=1e-5)
    loss = lambda *a: jnp.sum(jax_stem(*a, EPS, None, True)[0] * s["gy"])
    gx, gk, gg, gb = jax.grad(loss, argnums=(0, 1, 2, 3))(s["x"], s["k"], s["gamma"],
                                                          s["beta"])
    ours = dict(x=np.concatenate([g["d_x"] for g in got]),
                kernel=(got[0]["d_kernel"] + got[1]["d_kernel"]).transpose(2, 3, 1, 0),
                gamma=got[0]["d_gamma"] + got[1]["d_gamma"],
                beta=got[0]["d_beta"] + got[1]["d_beta"])
    for k, ref in (("x", gx), ("kernel", gk), ("gamma", gg), ("beta", gb)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours[k], ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)


# -- the full model at 64² --------------------------------------------------
def _leaf_check(after, ref_after, before, names):
    """tests/test_torch_trainer.py's per-leaf rule: {leaf: (error, tol)}."""
    noise = np.finfo(np.float32).eps * max(
        np.abs(ref_after[n] - before[n]).max() for n in names)
    out = {}
    for n in names:
        dj, dp = ref_after[n] - before[n], after[n] - before[n]
        ulp = np.spacing(np.float32(np.abs(before[n]).max()))
        out[n] = (np.abs(dp - dj).max(), 1e-3 * np.abs(dj).max() + 2 * ulp + noise)
    return out


def _assert_model_run(got, ref_raw, ref_ema, ref_losses, start, ties=(), tie_ref=None):
    """Both steps' losses; the first step's update leaf by leaf, BN
    statistics and EMA (the second compounds the first's rounding).  The
    leaves in `ties`, and their EMA, are held against `tie_ref`'s
    (parameters, EMA) instead."""
    names = list(got["params"])
    np.testing.assert_allclose([t[0] for t in got["terms"]], ref_losses, rtol=1e-4)
    checks = [_leaf_check(got["params"], ref_raw, start, names)]
    if ties:
        checks.append(_leaf_check(got["params"], tie_ref[0], start, names))
    errs = {n: checks[n in ties][n] for n in names}
    bad = {n: et for n, et in errs.items() if et[0] > et[1]}
    assert not bad, bad
    for k, v in got["batch_stats"].items():
        np.testing.assert_allclose(v, ref_raw[k], rtol=0, atol=1e-5, err_msg=k)
    for k, v in got["ema"].items():
        np.testing.assert_allclose(v, (tie_ref[1] if k in ties else ref_ema)[k],
                                   rtol=0, atol=1e-5, err_msg=k)


def _start(inputs):
    return {k: v.numpy() for k, v in from_jax_variables(inputs["variables"]).items()}


def test_split_matches_jax_split_on_two_devices(ranks, inputs, jax_runs):
    ref = jax_runs["split"]
    for r in ranks:
        got = r["split"]
        assert got["step_mode"] == "split" and got["train_stem"] == "kernel"
        _assert_model_run(got, ref["raw"], ref["ema"], ref["losses"], _start(inputs))


def test_fused_matches_the_one_process_step(ranks, inputs, one):
    """Fused over 2 ranks against the port's one-process trainer on the
    global batch: the same program up to float32 summation order."""
    for r in ranks:
        got = r["fused"]
        assert got["step_mode"] == "fused" and got["train_stem"] == "kernel"
        _assert_model_run(got, {**one["params"], **one["batch_stats"]}, one["ema"],
                          one["losses"], _start(inputs))


TIE_MODULE = "backbone_rgb.dark2_shuffle.b2_bn1"


def _tie_leaves(one, jax_fused, start):
    """Leaves on which the port's one-process step and the JAX fused step
    part beyond the per-leaf limit."""
    names = list(one["params"])
    return {n for n, (err, tol) in _leaf_check(one["params"], jax_fused["raw"], start,
                                               names).items() if err > tol}


def test_one_process_spread_from_jax_is_one_relu_tie(inputs, one, jax_runs):
    """The port's one-process fused step parts from the JAX one, both
    float32, only on leaves upstream of one ReLU: `TIE_MODULE` holds a
    pre-ReLU value within 1e-5 of zero in a channel of spread about 1, and
    the two frameworks' rounding moves it across (as
    tests/test_torch_trainer.py shows for its own batch)."""
    ties = _tie_leaves(one, jax_runs["fused"], _start(inputs))
    assert ties and all(n.startswith(("backbone_rgb.stem.", "backbone_rgb.dark2_"))
                        for n in ties), sorted(ties)
    spec = _model_spec(inputs, "fused")
    model = DCFAYolo(ModelConfig(**spec["cfg"]))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in spec["state_dict"].items()})
    seen = []
    model.get_submodule(TIE_MODULE).register_forward_hook(
        lambda mod, args, out: seen.append(out.detach()))
    with torch.no_grad():
        model.train_feats(*(torch.from_numpy(a) for a in inputs["batch"][:2]))
    pre = seen[0]
    at = np.unravel_index(int(pre.abs().argmin()), tuple(pre.shape))
    assert float(pre[at].abs()) < 1e-5 and float(pre[:, at[1]].std()) > 0.5


def test_fused_matches_jax_single_device_fused(ranks, inputs, jax_runs, one):
    """Against the JAX fused step on one device (JAX pins n devices ≡ 1,
    tests/test_fused_multidevice.py:66-79); on the one-process tie's leaves
    (above) against the port's one-process step."""
    ref, start = jax_runs["fused"], _start(inputs)
    ties = _tie_leaves(one, ref, start)
    for r in ranks:
        _assert_model_run(r["fused"], ref["raw"], ref["ema"], ref["losses"], start,
                          ties, (one["params"], one["ema"]))


def test_fused_normaliser_is_clamped_after_the_sum(ranks, inputs):
    """With no ground truth on one rank, its target scores sum to 0: the
    global normaliser (the sum over the ranks, clamped to 1 after it) keeps
    the fused loss the one-process loss; a per-rank clamp would not."""
    one = _one_process(inputs, batch=_half_empty(inputs["batch"]))
    for r in ranks:
        np.testing.assert_allclose(r["fused_half_empty"]["terms"][0][0], one["losses"][0],
                                   rtol=1e-4)


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_replicas_are_equal_after_every_step(ranks, mode):
    """Parameters, BN statistics, EMA and optimizer state equal bit for bit
    on both ranks after each of the two steps."""
    a, b = ranks[0][mode], ranks[1][mode]
    assert len(a["digests"]) == 2 and a["digests"] == b["digests"]
    assert a["terms"] == b["terms"] and a["ema_updates"] == b["ema_updates"] == 2


# -- serving --------------------------------------------------------------
def test_serving_shards_equal_the_one_process_call(ranks, inputs):
    model = init_model(ModelConfig(num_classes=2, phi="n", input_shape=(64, 64)), 0, "cpu")
    single = detect_batch(model, *inputs["serve"], **SERVE_KW)
    assert bool(single.valid.any())
    for f in single._fields:
        want = getattr(single, f)
        if want is None:
            continue
        got = np.concatenate([r["serve"]["result"][f] for r in ranks])
        if want.dtype.is_floating_point:
            np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(got, want.numpy(), err_msg=f)
    assert all(r["serve"]["launches"] == {"stem_eval": 0, "nms_suppress": 0} for r in ranks)


# -- the helpers and the loader -------------------------------------------
def test_shard_batch_and_reductions_without_a_group():
    batch = (np.arange(8), np.arange(16).reshape(8, 2), None)
    lo = shard_batch(batch, 1, 4)
    np.testing.assert_array_equal(lo[0], [2, 3])
    assert lo[2] is None
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(batch, 0, 3)
    x = torch.arange(3.0)
    assert all_reduce_sum(x, None) is x and all_reduce_mean(x, None) is x


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    make_dataset(str(d), 6, (160, 120))
    devkit = str(d / "VOCdevkit")
    voc.generate_imagesets(devkit, trainval_percent=1.0, train_percent=0.67)
    voc.generate_annotation_files(devkit, str(d / "model_data" / "voc_classes.txt"),
                                  out_dir=str(d), image_ext=".png")
    return d


def test_rank_loaders_slice_the_global_batches(dataset):
    """Two ranks' loaders give the rows of the one-process loader's batches,
    pixels, boxes and the padded tail's mask included."""
    lines = (dataset / "2007_train.txt").read_text().splitlines()
    ds = PairedDetectionDataset(lines + lines[:1], (64, 64), train=True)

    def batches(rank, world):
        return list(BatchLoader(ds, 4, 8, shuffle=True, drop_last=False, num_workers=1,
                                seed=5, rank=rank, world=world))

    whole, parts = batches(0, 1), [batches(r, 2) for r in range(2)]
    assert len(whole) == 2 and whole[-1].sample_mask.tolist() == [1, 0, 0, 0]
    for i, hb in enumerate(whole):
        for f in hb._fields:
            np.testing.assert_array_equal(
                np.concatenate([getattr(p[i], f) for p in parts]), getattr(hb, f), err_msg=f)
    with pytest.raises(ValueError, match="does not divide"):
        BatchLoader(ds, 3, 8, world=2)


# -- the training CLI -----------------------------------------------------
def _cli_args(d, save_dir, *extra):
    return ["--classes-path", str(d / "model_data" / "voc_classes.txt"),
            "--train-annotation", str(d / "2007_train.txt"),
            "--val-annotation", str(d / "2007_val.txt"),
            "--input-shape", "64", "64", "--batch-size", "4", "--compute-dtype", "float32",
            "--save-period", "1", "--eval-period", "1", "--num-workers", "1",
            "--unfreeze-epoch", "1", "--save-dir", str(save_dir), "--device", "cpu", *extra]


def _half_losses(dataset, save_dir, world=2):
    """The one-process train-step loss of each rank's slice of the first
    global batch (batch 4), from the CLI's own initial weights: a run that
    starts at its last epoch builds the trainer and takes no step."""
    rep = train_cli(_cli_args(dataset, save_dir, "--init-epoch", "1"))
    trainer, tc = rep["trainer"], rep["trainer"].tc
    assert rep["epochs"] == []
    with open(dataset / "2007_train.txt", encoding="utf-8") as f:
        ds = PairedDetectionDataset(
            f.readlines(), (64, 64), train=True, mosaic=tc.mosaic,
            mosaic_prob=tc.mosaic_prob, mixup=tc.mixup, mixup_prob=tc.mixup_prob,
            special_aug_ratio=tc.special_aug_ratio, epoch_length=tc.unfreeze_epoch)
    ds.set_epoch(0)
    start, losses = copy.deepcopy(trainer.state), []  # the getter aliases the model
    for r in range(world):
        loader = BatchLoader(ds, 4, tc.max_boxes, shuffle=True, num_workers=1,
                             seed=tc.seed, rank=r, world=world)
        loader.set_epoch(0)
        hb = next(iter(loader))
        trainer.state = start
        losses.append(float(trainer.train_step(trainer.put_batch(
            hb.rgb, hb.nir, hb.gt_boxes, hb.gt_labels, hb.gt_mask), 1e-2).total))
    return losses


def test_cli_trains_on_two_ranks(dataset, tmp_path):
    """`--distributed` on 2 ranks launched through the environment, as
    torchrun launches them: 'auto' is the split step on the CPU (as the JAX
    Trainer resolves it), rank 0 alone writes its log directory and
    checkpoints, and the one step's loss (4 train pairs, batch 4) is the
    mean of the one-process losses on each rank's half."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dcfa_yolo_tpu_torch.train", "--distributed",
             *_cli_args(dataset, tmp_path / f"rank{r}")],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        halves = _half_losses(dataset, tmp_path / "one")
    finally:
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=240)[0])
            finally:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "2 ranks, split step" in outs[0] and "Epoch 1/1" not in outs[1]
    assert not (tmp_path / "rank1").exists()
    logs = list((tmp_path / "rank0").iterdir())
    assert len(logs) == 1
    names = os.listdir(logs[0])
    assert "last_epoch_weights.ckpt" in names and any(n.startswith("ep001") for n in names)
    dp_loss = float((logs[0] / "epoch_loss.txt").read_text().split()[0])
    assert halves[0] != halves[1]
    np.testing.assert_allclose(dp_loss, np.mean(halves), rtol=1e-4)


def test_cli_refuses_what_it_cannot_run(dataset, tmp_path, monkeypatch):
    """No environment, a batch the world does not divide, more CUDA ranks
    than cards: each raises before any process group forms or file is
    written."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE"):
        train_cli(_cli_args(dataset, tmp_path / "a", "--distributed"))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        train_cli(_cli_args(dataset, tmp_path / "b", "--distributed"))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = _cli_args(dataset, tmp_path / "c", "--distributed")
    argv[argv.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="local rank 1 has no CUDA device"):
        train_cli(argv)
    assert not any(tmp_path.iterdir())


def test_dryrun_on_two_cpu_ranks():
    proc = subprocess.run([sys.executable, "-m", "dcfa_yolo_tpu_torch.parallel.dryrun",
                           "2", "--device", "cpu"], cwd=REPO, capture_output=True,
                          text=True, timeout=240, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    for r in range(2):
        for tag in ("[fused] ok", "[split] ok", "[fused-syncbn] ok"):
            assert any(f"rank {r} {tag}" in l for l in lines), lines
