"""Seeded weights for both sides, made on the device in a few large draws.

A train-graph state_dict is made from (name, shape) pairs: the entries of
one distribution are drawn together from one `torch.Generator` seeded with
the run's seed, in name order, and split.  Two sets of distributions,
frozen copies of the port's own (`models/yolo.py::_init_value` and
`train/init_weights.py::reference_weights_init`):

- `serving`: conv kernels and biases N(0, 0.05), BN scales N(1, 0.1),
  running means N(0, 0.2), running variances and BiFPN weights
  U(0.5, 1.5), so that an untrained detector's scores and boxes spread;
- `training`: the start of training, conv kernels N(0, 0.02), BN scales
  N(1, 0.02), biases 0, running means 0 and variances 1, BiFPN weights 1.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch


def _kind(name: str, shape: Tuple[int, ...]) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("running_var", "w"):
        return "scale"
    if leaf == "running_mean":
        return "mean"
    if leaf == "weight" and len(shape) == 1:
        return "gamma"
    if leaf == "weight":
        return "kernel"
    return "bias"


_SERVING = {"scale": ("uniform", 0.5, 1.5), "mean": ("normal", 0.0, 0.2),
            "gamma": ("normal", 1.0, 0.1), "kernel": ("normal", 0.0, 0.05),
            "bias": ("normal", 0.0, 0.05)}
_TRAINING = {"scale": ("const", 1.0, 0.0), "mean": ("const", 0.0, 0.0),
             "gamma": ("normal", 1.0, 0.02), "kernel": ("normal", 0.0, 0.02),
             "bias": ("const", 0.0, 0.0)}
KINDS = {"serving": _SERVING, "training": _TRAINING}


def make_state(names: Sequence[Tuple[str, Tuple[int, ...]]], seed: int,
               kind: str, device) -> Dict[str, torch.Tensor]:
    """The float32 state_dict for `names` on `device` from `seed`."""
    dists = KINDS[kind]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    groups: Dict[str, list] = {}
    for name, shape in sorted(names):
        groups.setdefault(_kind(name, shape), []).append((name, shape))
    out: Dict[str, torch.Tensor] = {}
    for k in sorted(groups):
        entries = groups[k]
        total = sum(int(torch.Size(s).numel()) for _, s in entries)
        how, a, b = dists[k]
        if how == "const":
            flat = torch.full((total,), a, device=device)
        elif how == "uniform":
            flat = torch.rand(total, generator=gen, device=device) * (b - a) + a
        else:
            flat = torch.randn(total, generator=gen, device=device) * b + a
        at = 0
        for name, shape in entries:
            n = int(torch.Size(shape).numel())
            out[name] = flat[at:at + n].view(shape).clone()
            at += n
    return out
