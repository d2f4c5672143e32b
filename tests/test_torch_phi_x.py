"""Phi x, DCFA-YOLO's largest phi (`dcfa_yolo_tpu_torch/config.py`: depth
1.00, width 1.25, deep width 0.50; 80 stem channels, base depth 3, 640
deep channels), at its published widths on the CPU, against the plain
float32 reference the benchmark judges with (`benchmark/reference/`, which
imports nothing of the port).  64² inputs, float32, TF32 off, seeded random
weights (`benchmark/benchlib/weights.py`):

- the eval forward, per anchor: the DFL-decoded box sides and the class
  logits;
- one train step through `Trainer` with the flat tail: the loss, the
  gradient by leaf (the SGD trace after the first step: the clipped
  gradient plus the weight decay) and every state entry's change
  (parameters, BN statistics, EMA);
- the fused data-parallel step over 2 gloo ranks (b2 each) against the
  reference's one-process b4 step: the fused step's BN moments and loss
  normaliser are the global batch's.

Each number is the worst over its anchors or leaves; a leaf's gap is
‖a − b‖ over the larger of ‖b‖ and the median leaf's ‖b‖ (the measure of
`benchmark/benchlib/judge_train.py`, where a leaf whose own norm is tiny
is measured against the median leaf).  The tolerances are set above what
float32 reordering gives here (`python tests/test_torch_phi_x.py` prints
the readings) and below the reference computed in fp8
(`reference/precision.py`), which each case is also shown to fail.  The
file compiles no JAX: phi x's eval forward against the JAX package's is
`tests/test_torch_scales.py::test_phi_x_forward_matches_jax`.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from benchlib import weights  # noqa: E402
from reference.model import ReferenceYolo, Sizes, state_names  # noqa: E402
from reference.precision import ieee  # noqa: E402
from reference.train import ReferenceTrainer  # noqa: E402

torch.set_num_threads(1)
HW = (64, 64)
SIZES = Sizes("x", 1, 16, HW)
LR = 0.01

# Tolerances, each the worst over anchors or leaves.  Readings on the CPU
# (`python tests/test_torch_phi_x.py` prints them): the port against
# float32 / the reference in fp8 against float32.
# Eval forward, max |Δ| of the decoded box sides (feature units, 0-15) and
# of the raw class logits: 2.4e-6 and 0 / 1.51 and 3.83.  1e-3 leaves the
# port's own float32 reordering (sums over up to 640 channels) 400 times
# its reading and fails fp8 by 1,500 times.
TOL_EVAL = {"dbox": 1e-3, "cls": 1e-3}
# Train step, the loss relative, the gradient's and the state change's
# worst leaf: one process reads 0, 0, 0 (the plain graph runs the
# reference's operations in its order); the fused step over 2 ranks
# 3.5e-7, 1.3e-4, 2.3e-3 (its BN moments and gradient summed in another
# order; the change's worst leaf is a BN running mean fed by another BN,
# zero in exact arithmetic and measured against its group's median); fp8
# 0.051, 6.20, 6.20.  Each limit sits above the fused step's reading (4
# to 30 times) and below fp8's (600 to 5,000 times).
TOL_STEP = {"loss": 1e-5, "grad": 1e-3, "change": 1e-2}


def _median(xs):
    s = sorted(xs)
    return s[len(s) // 2] if s else 0.0


def worst_leaf(mine, ref, names=None) -> float:
    """max over `names` of ‖a − b‖ / max(‖b‖, the median leaf's ‖b‖)."""
    names = list(ref) if names is None else list(names)
    norms = {n: float(ref[n].double().norm()) for n in names}
    med = _median(list(norms.values()))
    gaps = [float((mine[n].double() - ref[n].double()).norm()) / max(norms[n], med, 1e-30)
            for n in names]
    gaps = [g if g == g else float("inf") for g in gaps]
    return max(gaps)


def state_gaps(mine_before, mine_after, ref_before, ref_after) -> float:
    """The worst leaf of every state entry's change, within each group
    (parameters, BN statistics, and the EMA of each), whose changes
    differ in scale by orders of magnitude."""
    ch = lambda a, b: {k: a[k] - b[k] for k in b}  # noqa: E731
    mine, ref = ch(mine_after, mine_before), ch(ref_after, ref_before)
    params = {k for k in ref if not k.startswith("ema.")
              and not k.rsplit(".", 1)[-1].startswith("running_")}
    groups = [
        [k for k in ref if k in params],
        [k for k in ref if k.startswith("ema.") and k[4:] in params],
        [k for k in ref if not k.startswith("ema.") and k not in params],
        [k for k in ref if k.startswith("ema.") and k[4:] not in params],
    ]
    return max(worst_leaf(mine, ref, g) for g in groups if g)


def _state(sd):
    return {k: v.detach().clone() for k, v in sd.items() if v.is_floating_point()}


def _batch(b, seed=1):
    g = torch.Generator().manual_seed(seed)
    rgb, nir = torch.rand(b, *HW, 3, generator=g), torch.rand(b, *HW, 3, generator=g)
    boxes = torch.zeros(b, 2, 4)
    mask = torch.zeros(b, 2)
    for i in range(b):
        boxes[i, 0] = torch.tensor([4.0 + 3 * i, 6.0, 30.0 + 4 * i, 44.0])
        mask[i, 0] = 1
        if i % 2:
            boxes[i, 1] = torch.tensor([20.0, 18.0, 60.0, 50.0])
            mask[i, 1] = 1
    return rgb, nir, boxes, torch.zeros(b, 2), mask


def _port_model(sd):
    from dcfa_yolo_tpu_torch.config import ModelConfig
    from dcfa_yolo_tpu_torch.models.reparam import serving_state_dict
    from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo

    cfg = ModelConfig(phi="x", input_shape=HW, compute_dtype="float32",
                      train_stem_backend="plain")
    m = DCFAYolo(cfg)
    m.load_state_dict(serving_state_dict(sd, False, False), strict=True)
    return m


def _ref_model(sd, precision="float32"):
    m = ReferenceYolo(SIZES, precision)
    m.load_state_dict(sd, strict=True)
    return m


def eval_gaps(outs, ref_outs):
    return {"dbox": float((outs[0] - ref_outs[0]).abs().max()),
            "cls": float((outs[1] - ref_outs[1]).abs().max())}


def eval_readings(precision="float32"):
    """The eval forward's gaps: the port's (or, with `precision`, the
    reference's in that precision) against the float32 reference's."""
    sd = weights.make_state(state_names(SIZES), 12, "serving", "cpu")
    rgb, nir = _batch(2)[:2]
    with torch.no_grad(), ieee():
        ref = _ref_model(sd).eval()(rgb, nir)
        if precision == "float32":
            got = _port_model(sd).eval()(rgb, nir)
        else:
            got = _ref_model(sd, precision).eval()(rgb, nir)
    return eval_gaps(got, ref)


def ref_step(sd, batch, precision="float32"):
    """The reference's one step from `sd`: (loss, trace, state before,
    state after)."""
    with ieee():
        rt = ReferenceTrainer(_ref_model(sd, precision), "cpu")
        before = rt.state()
        loss = rt.step(*batch, LR)[0]
        return loss, {k: v.clone() for k, v in rt.trace.items()}, before, rt.state()


def step_gaps(got, ref):
    """(loss, trace, before, after) of a step against the reference's."""
    return {"loss": abs(got[0] - ref[0]) / abs(ref[0]),
            "grad": worst_leaf(got[1], ref[1]),
            "change": state_gaps(got[2], got[3], ref[2], ref[3])}


def port_step(trainer, batch):
    """One port step: (loss, trace, state before, state after), in the
    reference's names (params, BN statistics, `ema.` entries)."""
    from dcfa_yolo_tpu_torch.train.trainer import Batch

    def state():
        out = _state(trainer.model.state_dict())
        out.update({f"ema.{k}": v.clone() for k, v in trainer.ema.variables.items()})
        return out

    before = state()
    lb = trainer.train_step(Batch(*batch), LR)
    trace = {k: v.clone() for k, v in trainer.optimizer.state()["trace"].items()}
    return float(lb.total), trace, before, state()


def step_readings(precision="float32"):
    from dcfa_yolo_tpu_torch.config import TrainConfig
    from dcfa_yolo_tpu_torch.train.trainer import Trainer

    sd = weights.make_state(state_names(SIZES), 11, "training", "cpu")
    batch = _batch(2)
    ref = ref_step(sd, batch)
    if precision == "float32":
        tr = Trainer(_port_model(sd), TrainConfig(batch_size=2), device="cpu")
        assert not tr.graph_route
        got = port_step(tr, batch)
    else:
        got = ref_step(sd, batch, precision)
    return step_gaps(got, ref)


def _fused_rank(rank, world, group):
    """One fused step on this rank's half of the b4 batch; rank 0 also
    takes the reference's b4 step and returns the gaps, each rank a hash
    of its state after."""
    import hashlib

    from dcfa_yolo_tpu_torch.config import TrainConfig
    from dcfa_yolo_tpu_torch.parallel.mesh import shard_batch
    from dcfa_yolo_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    sd = weights.make_state(state_names(SIZES), 13, "training", "cpu")
    batch = _batch(4, seed=3)
    tr = Trainer(_port_model(sd), TrainConfig(batch_size=4), device="cpu", group=group,
                 step_mode="fused")
    got = port_step(tr, shard_batch(batch, rank, world))
    h = hashlib.sha256()
    for k in sorted(got[3]):
        h.update(got[3][k].numpy().tobytes())
    gaps = step_gaps(got, ref_step(sd, batch)) if rank == 0 else None
    return gaps, h.hexdigest()


def fused_readings():
    from dcfa_yolo_tpu_torch.parallel.mesh import run_ranks

    (gaps, h0), (_, h1) = run_ranks(_fused_rank, 2)
    return gaps, h0 == h1


@pytest.fixture(scope="module")
def sizes_checked():
    from dcfa_yolo_tpu_torch.config import ModelConfig
    from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo

    m = DCFAYolo(ModelConfig(phi="x", input_shape=HW))
    assert m.cfg.base_channels == 80 and m.cfg.base_depth == 3
    assert m.cfg.deep_channels == 640
    n = sum(p.numel() for p in m.parameters())
    assert n == sum(p.numel() for p in ReferenceYolo(SIZES).parameters()) == 37_962_370
    return True


def test_published_widths(sizes_checked):
    assert sizes_checked


@pytest.mark.parametrize("precision", ["float32", "fp8"])
def test_eval_forward_per_anchor(sizes_checked, precision):
    got = eval_readings(precision)
    within = {k: v <= TOL_EVAL[k] for k, v in got.items()}
    if precision == "float32":
        assert all(within.values()), got
    else:  # the control: the comparison must see fp8
        assert not all(within.values()), got


@pytest.mark.parametrize("precision", ["float32", "fp8"])
def test_train_step(sizes_checked, precision):
    got = step_readings(precision)
    within = {k: v <= TOL_STEP[k] for k, v in got.items()}
    if precision == "float32":
        assert all(within.values()), got
    else:
        assert not all(within.values()), got


def test_fused_step_over_two_ranks(sizes_checked):
    gaps, replicas_equal = fused_readings()
    assert replicas_equal
    assert all(v <= TOL_STEP[k] for k, v in gaps.items()), gaps


if __name__ == "__main__":
    print("eval", eval_readings(), "fp8", eval_readings("fp8"))
    print("step", step_readings(), "fp8", step_readings("fp8"))
    print("fused", *fused_readings())
