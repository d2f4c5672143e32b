"""Judging a training run's steps against the reference's.

Two parts are judged, each the program's against the reference's on the
same batch parameters:

- `setup`: the first steps, which set-up runs through the window's own
  loader and `train_step` from the seed's weights, and the reference
  follows from the same weights;
- `window`: one step taken from the measured window, at an index drawn
  from the seed: the reference starts from the program's state just
  before it (parameters, BN statistics, SGD trace, EMA) and takes the
  step on the batch it works out again itself.

The numbers of a part, each the worst over its leaves or steps:

- `loss_gap`: |L − L_ref| / |L_ref| of the part's first step's total loss
  (`loss_gap_steps`: the largest over its steps, reported, not compared);
- `grad_gap`: the gradient as the optimizer got it (its momentum trace's
  increment: the clipped gradient plus the weight decay), by leaf:
  ‖g − g_ref‖ over the larger of ‖g_ref‖ and the median leaf's ‖g_ref‖;
  the median over the leaves (`grad_gap_worst`: the largest, reported,
  not compared);
- `change_gap`: the change of every floating state entry over the part's
  steps, by leaf, measured as `grad_gap` is within each of four groups
  (parameters, BN statistics, and the EMA of each), since their changes
  differ in scale by orders of magnitude; the largest of the groups'
  medians (`change_gap_worst`: the largest leaf's, reported);
- `batch_px_gap`: the augmented images, the mean absolute difference in
  uint8 steps (×255) (`batch_px_worst`: the largest, reported);
- `batch_box_gap`: the augmented boxes, labels and masks, the largest
  difference: the program computes them in float32 and float64 at every
  precision, so they match exactly.

Each part's gradient and change are compared apart, as `<number>.<part>`
(the first gradient at the seed's weights reads further from float32 than
a later one, so one limit for both would leave the window's step loose),
and so is the set-up part's loss; the batches' two numbers are the larger
of the parts'.  The window step's loss is reported, not compared: the
precision control's reads as little as twice a sound run's there, and no
fault reads ten times it, so no limit would separate them; the window
step's faults show in its gradient and change.

The worst leaf swings from seed to seed by nature: the small leaves (the
spatial attention's 7x7 convs, the BiFPN weights, a stem BN's scale) take
their gradients as small remainders of large sums that cancel, and every
bfloat16 rounding upstream moves them; the worst pixel sits where a bf16
resample flips the HSV hue's wrap; the later steps' losses move with the
assigner's discrete choices on some batches.  The medians, the mean and
each part's first step are what is compared.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by rounding alone (a key's bias under softmax): they, and
their EMA, are left out of `grad_gap` and `change_gap`.  So are BN
statistics whose reference change is under a thousandth of their group's
median: the running mean of a BN fed by another BN's output, whose batch
mean is zero in exact arithmetic.  Both sides come in the reference's
layout: the driver unfolds the program's channel-shuffle fold first.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

QUIET = 1e-3
PARTS = ("setup", "window")
COMPARED = ("loss_gap.setup", "grad_gap.setup", "change_gap.setup", "grad_gap.window",
            "change_gap.window", "batch_px_gap", "batch_box_gap")


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2] if s else 0.0


def leaf_gaps(mine: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: Iterable[str]) -> Dict[str, float]:
    """‖a − b‖ / max(‖b‖, median ‖b‖) of each leaf in names."""
    names = list(names)
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = _median(list(rn.values()))
    gaps = {n: float((mine[n].double() - ref[n].double()).norm()) / max(rn[n], med, 1e-30)
            for n in names}
    return {n: g if g == g else float("inf") for n, g in gaps.items()}  # NaN fails


def _worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    return max(((v, n) for n, v in gaps.items()), default=(0.0, ""))


def moving(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference value (gradient or change) is not nought to
    rounding: at least a thousandth of the median leaf's norm."""
    norms = {n: float(g.double().norm()) for n, g in ref_grad.items()}
    med = _median(list(norms.values()))
    return [n for n, v in norms.items() if v >= QUIET * med]


def judge_part(port: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """`port` and `ref`: losses (list of totals), grad (by parameter),
    change (by state entry), images (list of (rgb, nir)), targets (list of
    (boxes, labels, mask)).  Returns every number with its worst leaf's
    name where it has one."""
    live = moving(ref["grad"])
    out = {}
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(port["losses"], ref["losses"])]
    gaps = [g if g == g else float("inf") for g in gaps]
    out["loss_gap"] = (gaps[0], "")
    out["loss_gap_steps"] = (max(gaps), "")
    grads = leaf_gaps(port["grad"], ref["grad"], live)
    out["grad_gap"] = (_median(list(grads.values())), "")
    out["grad_gap_worst"] = _worst(grads)
    params = set(ref["grad"])
    stats = [n for n in ref["change"] if n not in params and not n.startswith("ema.")]
    live_stats = sorted(moving({n: ref["change"][n] for n in stats}))
    med, worst = (0.0, ""), (0.0, "")
    for group in (live, [f"ema.{n}" for n in live], live_stats,
                  [f"ema.{n}" for n in live_stats]):
        gaps = leaf_gaps(port["change"], ref["change"], group)
        med = max(med, (_median(list(gaps.values())), ""))
        worst = max(worst, _worst(gaps))
    out["change_gap"], out["change_gap_worst"] = med, worst
    diffs = [(a.float() - b.float()).abs() * 255.0
             for (pr, pn), (rr, rn) in zip(port["images"], ref["images"])
             for a, b in ((pr, rr), (pn, rn))]
    px = float(torch.cat([d.reshape(-1) for d in diffs]).mean())
    out["batch_px_gap"] = (px if px == px else float("inf"), "")
    out["batch_px_worst"] = (max(float(d.max()) for d in diffs), "")
    box = 0.0
    for pt, rt in zip(port["targets"], ref["targets"]):
        for a, b in zip(pt, rt):
            d = float((a.float() - b.float()).abs().max())
            box = max(box, d if d == d else float("inf"))
    out["batch_box_gap"] = (box, "")
    return out


def judge(port: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """`port` and `ref`: a record (as `judge_part` takes) under each of
    PARTS.  Returns every part's numbers as `<number>.<part>`, and the
    batches' numbers over both parts (`batch_px_gap`, `batch_box_gap`,
    each the larger of its parts')."""
    parts = {p: judge_part(port[p], ref[p]) for p in PARTS}
    out = {k: (max(parts[p][k][0] for p in PARTS), "")
           for k in ("batch_px_gap", "batch_box_gap")}
    for p, got in parts.items():
        out.update({f"{k}.{p}": v for k, v in got.items()})
    return out
