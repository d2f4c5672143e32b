"""A copy of the benchmark with tiny cells, for runs on the CPU: 64x64
inputs, short windows, small pools and datasets."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def tiny_root(tmp: Path, limits=None) -> Path:
    """`tmp` holding `benchmark/` (copied) and a BENCHMARK.json whose cells
    are the real ones cut to CPU size; returns `tmp`."""
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((BENCH.parent / c["file"]).read_text())
        cfg["input_shape"] = [64, 64]
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for f in (tmp / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t["image_hw"] = [48, 64]
        if t["driver"] == "serve":
            t.update(pool=2, batch=min(t["batch"], 2), sample_calls=2, trace_calls=2,
                     warmup_calls=1)
        else:
            t.update(batch=2, dataset_pairs=4, trace_steps=1, judged_step=[1, 2])
        f.write_text(json.dumps(t))
    for w in bench["workloads"]:
        lim = tmp / "benchmark" / "limits" / f"{w['name']}.json"
        if limits is not None and lim.exists():
            lim.write_text(json.dumps(limits))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
