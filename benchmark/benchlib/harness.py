"""One run of one cell: the device check, the cell's driver, the per-layer
readers, the JAX check, the check of the cards the run used, and the
result line.

The driver (`benchmark/drivers/<driver>.py`) sets the system up, measures
for `--seconds`, optionally traces, then judges what the timed path
produced against the plain reference; it returns an `Outcome`, which
names the card of every process that stepped the timed work.  This module
turns that into the last line of standard output, one JSON object, whose
`device` block counts those cards, and prints each compared number beside
its limit as the last lines of standard error and under the result's last
key, `checks`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

FORBIDDEN = ("jax", "jaxlib", "flax", "dcfa_yolo_tpu")


@dataclass
class Context:
    cell: "object"
    seed: int
    seconds: float
    trace: bool
    device: "object"
    t0: float  # process start, time.perf_counter's clock

    def say(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


@dataclass
class Outcome:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]
    memory_peak_bytes: int
    cards: List[Dict]  # `card_of` each process that ran the timed work
    layer: Dict = field(default_factory=dict)  # what the per-layer readers take
    trace: Optional[object] = None             # benchlib.trace.Trace

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for v, lim in self.checks.values())


def sync(dev) -> None:
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_of(dev) -> Dict:
    """The card this process ran its timed work on, as its own `torch.cuda`
    sees it: index, name and identity (the CPU has neither index nor
    identity)."""
    import torch

    if dev.type != "cuda":
        return {"index": None, "name": "cpu", "uuid": None}
    i = torch.cuda.current_device() if dev.index is None else dev.index
    return {"index": i, "name": torch.cuda.get_device_name(i),
            "uuid": str(torch.cuda.get_device_properties(i).uuid)}


def cards_used(cards: Sequence[Dict], chips: Optional[int]) -> Tuple[int, str]:
    """The number of distinct cards (by identity) among `cards` and their
    common name.  With `chips` (a run on cards), raises ValueError where
    fewer than `chips` distinct cards ran the timed work, or cards of
    different kinds."""
    count = len({c["uuid"] for c in cards})
    kinds = sorted({c["name"] for c in cards})
    if chips is not None:
        if count < chips:
            raise ValueError(f"the cell asks for {chips} card(s); its timed work ran on "
                             f"{count} distinct card(s): {list(cards)}")
        if len(kinds) != 1:
            raise ValueError(f"the cell's timed work ran on cards of different kinds: "
                             f"{list(cards)}")
    return count, kinds[0] if kinds else ""


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's,
    flax's or the JAX package's (compared whole: the port's name begins
    with the JAX package's)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, *, t0: Optional[float] = None,
         device: Optional[str] = None, root: Optional[Path] = None,
         out=None) -> int:
    """Run a cell and print its result.  `device` and `root` are for the
    CPU tests: a given `device` skips the look for a card (`"cpu"`, or
    `"cuda"` under a driver that makes up its cards), `root` is a checkout
    with its own BENCHMARK.json.  Returns the exit code."""
    t0 = time.perf_counter() if t0 is None else t0
    out = out or sys.stdout
    args = parse(argv)
    import torch

    from benchlib import spec

    cell = spec.load_cell(args.workload, root)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"needs {cell.chips} CUDA device(s); this machine has {have}",
                  file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), dev, t0)
    outcome: Outcome = spec.driver(cell.traffic, root).run(ctx)

    metrics: Dict[str, Dict] = {}
    if not args.trace:
        for m in cell.end_to_end:
            if m["name"] not in outcome.e2e:
                raise KeyError(f"cell {cell.name} reports no {m['name']}")
            metrics[m["name"]] = {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
    else:
        ctx_layer = dict(outcome.layer, trace=outcome.trace, cell=cell)
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"], root).read(ctx_layer)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package is loaded in this process: {bad}", file=sys.stderr)
        return 3
    try:
        count, kind = cards_used(outcome.cards, cell.chips if dev.type == "cuda" else None)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    print(f"cards: {outcome.cards}", file=sys.stderr)
    result = {
        "correct": outcome.correct,
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": kind,
            "count": count,
            "memory_peak_bytes": int(outcome.memory_peak_bytes),
        },
    }
    if args.trace and outcome.trace is not None:
        tr = outcome.trace
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct: {outcome.correct}", file=sys.stderr, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return 0
