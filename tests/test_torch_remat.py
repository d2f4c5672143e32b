"""Backbone rematerialization of the port (`ModelConfig.remat`,
`models/yolo.py::DCFAYolo._backbone`, `torch.utils.checkpoint`) on the CPU
at 64²: against the port without it, against the JAX model with
`ModelConfig(remat=True)` (tests/test_remat.py holds the JAX one against
itself), and over 2 gloo ranks.

Tolerances.  With and without remat the port runs the same ops in the
same order: outputs and gradients within 1e-6, the running statistics
after a train step and the whole state after a `Trainer.train_step`
equal bit for bit; without the once-only guard (`ops/norm.py::
recomputing`) the recompute moves every backbone BN's statistics a second
time, and they differ.  Against JAX: tests/test_torch_trainer.py's
tolerances (loss rtol 1e-4, each gradient leaf within 1e-3 of its
largest reference entry plus float32 eps times the largest entry of the
whole gradient; BN statistics atol 1e-5), the JAX model on its XLA stem
and the port on kernel C's graph (its plain twin here), at b8.  Leaves
whose reference and difference both lie within 1e-6 of the gradient's
largest entry are zero in exact arithmetic (biases that feed a train BN)
and rounding noise on both sides: exempt, as chip_smoke.py's [dp] exempts
them.  At b2 the P5 maps are 2×2 and their train BN normalises 8 values:
there one head leaf parts by 1.1e-3 of its largest entry, as the JAX
package's own two stem graphs part at such sizes
(tests/test_torch_parallel.py).  Two ranks, fused step:
tests/test_torch_parallel.py's limits against the one-process step.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcfa_yolo_tpu.config import ModelConfig as JaxModelConfig
from dcfa_yolo_tpu.models.yolo import DCFAYolo as JaxDCFAYolo
from dcfa_yolo_tpu.train.init_weights import reference_weights_init as jax_init
from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
from dcfa_yolo_tpu_torch.models import yolo
from dcfa_yolo_tpu_torch.models.convert import from_jax_variables
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo, init_model
from dcfa_yolo_tpu_torch.ops.norm import BatchNorm
from dcfa_yolo_tpu_torch.parallel import dryrun
from dcfa_yolo_tpu_torch.parallel.mesh import run_ranks
from dcfa_yolo_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

HW = (64, 64)
B = 2
CFG = ModelConfig(num_classes=2, phi="n", input_shape=HW, train_stem_backend="kernel")
REMAT = dataclasses.replace(CFG, remat=True)
DP_B = 8  # the 2-rank step's global batch (4 a rank), as tests/test_torch_parallel.py
JAX_B = 8


def _inputs(b=B):
    rng = np.random.Generator(np.random.PCG64(7))
    return tuple(torch.from_numpy(rng.random((b, *HW, 3), np.float32)) for _ in range(2))


def _two_rank_spec():
    sd = {k: v.numpy() for k, v in init_model(
        dataclasses.replace(REMAT, num_classes=1), 5, "cpu", train=True).state_dict().items()}
    return dict(cfg=dict(num_classes=1, phi="n", input_shape=HW,
                         train_stem_backend="kernel", remat=True),
                state_dict=sd, batch=dryrun.dry_batch(DP_B, HW, seed=3),
                step_mode="fused", tc=dict(max_boxes=4), steps=2, lr=1e-2)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The fused step on 2 gloo ranks, started in a thread so that the
    ranks run while this process compiles the JAX reference."""
    spec = _two_rank_spec()
    with ThreadPoolExecutor(1) as pool:
        yield spec, pool.submit(run_ranks, dryrun.train_rank, 2, (spec,),
                                store_dir=str(tmp_path_factory.mktemp("store")))


def _train_pass(cfg, guard=True):
    """One train forward and backward of a fresh model (the reference init,
    seed 0): raw maps, eval outputs before it, gradients, state_dict after."""
    model = init_model(cfg, 0, "cpu", train=True)
    rgb, nir = _inputs()
    with torch.no_grad():
        ev = model.eval()(rgb, nir)
    model.train()
    with pytest.MonkeyPatch.context() as mp:
        if not guard:
            mp.setattr(yolo, "recomputing", contextlib.nullcontext)
        feats = model.train_feats(rgb, nir)
        loss = sum((f.float() ** 2).mean() for f in feats)
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return dict(eval=(ev.dbox, ev.cls), feats=feats, grads=grads,
                names=[n for n, _ in model.named_parameters()],
                state={k: v.clone() for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def passes(spawned):
    return {"plain": _train_pass(CFG), "remat": _train_pass(REMAT),
            "unguarded": _train_pass(REMAT, guard=False)}


def test_state_dict_is_the_same_tree():
    a, b = DCFAYolo(CFG).state_dict(), DCFAYolo(REMAT).state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)
    DCFAYolo(REMAT).load_state_dict(init_model(CFG, 1, "cpu").state_dict(), strict=True)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_forward_matches_no_remat(passes, mode):
    outs = [passes[k]["feats" if mode == "train" else "eval"] for k in ("plain", "remat")]
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6)


def test_gradients_match_no_remat(passes):
    for n, a, b in zip(passes["plain"]["names"], passes["plain"]["grads"],
                       passes["remat"]["grads"]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6, msg=n)


def test_running_statistics_move_once(passes):
    """After one train pass the BN statistics (both stems' included) are the
    no-remat ones bit for bit: the recompute in the backward leaves them."""
    plain, remat = passes["plain"]["state"], passes["remat"]["state"]
    start = init_model(CFG, 0, "cpu", train=True).state_dict()
    for k in ("backbone_rgb.stem.bn.running_mean", "backbone_nir.dark5_sppf.cv2.bn.running_var"):
        assert not torch.equal(plain[k], start[k]), k
    for k, v in plain.items():
        assert torch.equal(remat[k], v), k


def test_without_the_guard_the_recompute_moves_them_again(passes):
    """The check above fails with the once-only guard removed: every
    backbone BN takes a second momentum step in the recompute."""
    plain, bad = passes["plain"]["state"], passes["unguarded"]["state"]
    model = DCFAYolo(CFG)
    backbone_bns = [n for n, m in model.named_modules()
                    if isinstance(m, BatchNorm) and n.startswith("backbone_")]
    differ = [n for n in backbone_bns
              if not torch.equal(bad[n + ".running_var"], plain[n + ".running_var"])]
    assert set(differ) == set(backbone_bns)
    neck = "conv3_for_upsample1.cv1.bn.running_var"
    assert torch.equal(bad[neck], plain[neck])


def test_train_step_on_the_flat_tail_matches_no_remat():
    batch = dryrun.dry_batch(B, HW, seed=4)
    out = []
    for cfg in (CFG, REMAT):
        model = DCFAYolo(dataclasses.replace(cfg, num_classes=1))
        model.load_state_dict(init_model(dataclasses.replace(CFG, num_classes=1), 2,
                                         "cpu", train=True).state_dict())
        tr = Trainer(model, TrainConfig(max_boxes=4), device="cpu")
        lb = tr.train_step(tr.put_batch(*batch), 1e-2)
        out.append((lb, tr.flat_state))
    (la, sa), (lb_, sb) = out
    assert all(torch.equal(x, y) for x, y in zip(la, lb_))
    for name in ("flat_params", "flat_stats", "ema_p", "ema_s"):
        assert torch.equal(getattr(sa, name), getattr(sb, name)), name


def _jax_variables():
    """tests/test_torch_trainer.py's recipe: the flax tree from eval_shape,
    filled as flax's initializers fill it, then the reference init."""
    cfg = JaxModelConfig(num_classes=1, phi="n", input_shape=HW)
    dummy = jnp.zeros((JAX_B, *HW, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JaxDCFAYolo(cfg).init(
        jax.random.PRNGKey(0), dummy, dummy, train=False))
    fill = lambda path, x: (np.ones if jax.tree_util.keystr(path).endswith(
        ("['w']", "['var']")) else np.zeros)(x.shape, np.float32)
    variables = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    variables["params"] = jax_init(variables["params"], seed=1)
    return variables


def test_train_forward_and_gradient_match_jax_remat(spawned):
    variables = _jax_variables()
    rgb, nir = (x.numpy() for x in _inputs(JAX_B))
    jcfg = JaxModelConfig(num_classes=1, phi="n", input_shape=HW, remat=True,
                          train_stem_backend="xla")

    def jloss(params):
        out, st = JaxDCFAYolo(jcfg).apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            rgb, nir, True, mutable=["batch_stats"])
        return jnp.mean(out.dbox ** 2) + jnp.mean(out.cls ** 2), st

    (l_j, st_j), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    ref = {k: v.numpy() for k, v in from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, g_j),
         "batch_stats": jax.tree_util.tree_map(np.asarray, st_j["batch_stats"])}).items()}

    model = DCFAYolo(dataclasses.replace(REMAT, num_classes=1))
    model.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, variables)))
    out = model.train()(torch.from_numpy(rgb), torch.from_numpy(nir))
    loss = (out.dbox ** 2).mean() + (out.cls ** 2).mean()
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-4)
    top = max(np.abs(ref[n]).max() for n, _ in named)
    bad, exempt = {}, []
    for (n, _), g in zip(named, grads):
        err, big = np.abs(g.numpy() - ref[n]).max(), np.abs(ref[n]).max()
        if big <= 1e-6 * top and err <= 1e-6 * top:
            exempt.append(n)
        elif err > 1e-3 * big + np.finfo(np.float32).eps * top:
            bad[n] = (err, big)
    assert not bad, bad
    assert len(exempt) < len(named) // 4, exempt
    for k, v in model.state_dict().items():
        if "running_" in k:
            np.testing.assert_allclose(v.numpy(), ref[k], rtol=0, atol=1e-5, err_msg=k)


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


def test_two_ranks_fused_with_remat_match_one_process(spawned):
    """The fused step with remat on 2 gloo ranks (b4 each; the recompute
    repeats the BN and kernel C all-reduces inside the backward, on
    both ranks in one order) against the one-process step with remat on
    the global b8: both losses, the first step's update leaf by leaf, BN
    statistics and EMA; replicas equal after each step."""
    spec, fut = spawned
    ranks = fut.result()
    model = DCFAYolo(ModelConfig(**spec["cfg"]))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in spec["state_dict"].items()})
    tr = Trainer(model, TrainConfig(max_boxes=4), device="cpu")
    b = tr.put_batch(*spec["batch"])
    losses = [float(tr.train_step(b, spec["lr"]).total)]
    st = tr.state
    one = {k: v.numpy().copy() for d in (st.params, st.batch_stats) for k, v in d.items()}
    ema = {k: v.numpy().copy() for k, v in st.ema.items()}
    losses.append(float(tr.train_step(b, spec["lr"]).total))
    names = list(st.params)
    for r in ranks:
        assert r["step_mode"] == "fused" and r["train_stem"] == "kernel"
        assert r["digests"] == ranks[0]["digests"]
        np.testing.assert_allclose([t[0] for t in r["terms"]], losses, rtol=1e-4)
        errs = _leaf_check(r["params"], one, spec["state_dict"], names)
        bad = {n: et for n, et in errs.items() if et[0] > et[1]}
        assert not bad, bad
        for k, v in r["batch_stats"].items():
            np.testing.assert_allclose(v, one[k], rtol=0, atol=1e-5, err_msg=k)
        for k, v in r["ema"].items():
            np.testing.assert_allclose(v, ema[k], rtol=0, atol=1e-5, err_msg=k)
