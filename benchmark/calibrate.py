"""Readings for a cell's correctness limits, in one process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n>... [--control-seeds <n>...] [--fault-seeds <n>...]

For each of `--seeds` it runs the cell's timed path (a window of
`--seconds`) and prints the compared numbers (the lower readings); for each
of `--control-seeds` the precision control's (`benchlib/control.py`); for
each of `--fault-seeds` the numbers with each fault of
`benchlib/faults.py` planted; for each of `--witness-seeds` the reference
in bfloat16 against float32.  One JSON line per reading on standard
output.  Benchmark runs never call this."""

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None, device=None, root=None) -> int:
    import torch

    from benchlib import control, faults, spec
    from benchlib.harness import Context

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--witness-seeds", type=int, nargs="*", default=[],
                   help="the reference in bfloat16 against float32: what the "
                        "configuration's own rounding does to the numbers")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload, root)
    dev = torch.device(device or "cuda")
    drv = spec.driver(cell.traffic, root)
    kind = cell.traffic["driver"]

    def emit(what, seed, checks, extra=None):
        line = {"cell": cell.name, "what": what, "seed": seed,
                "checks": {k: v[0] if isinstance(v, tuple) else v for k, v in checks.items()}}
        line.update(extra or {})
        print(json.dumps(line), flush=True)

    def sound(seed):
        ctx = Context(cell, seed, args.seconds, False, dev, time.perf_counter())
        out = drv.run(ctx)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    for seed in args.seeds:
        out = sound(seed)
        emit("sound", seed, out.checks, {"e2e": out.e2e})
    for seed in args.control_seeds:
        emit("control", seed, control.run(cell, seed, dev))
    for seed in args.witness_seeds:
        emit("witness:bfloat16", seed, control.run(cell, seed, dev, "bfloat16"))
    for seed in args.fault_seeds:
        for fault in faults.applicable(cell):
            with faults.planted(kind, fault):
                out = sound(seed)
            emit(f"fault:{fault}", seed, out.checks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
