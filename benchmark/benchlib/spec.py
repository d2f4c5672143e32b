"""Finding a cell's parts by name.

`BENCHMARK.json` at the checkout's root names each cell
`<traffic>.<config>` and lists the metrics.  Everything else is a file of
its own under `benchmark/`, found by name:

- a configuration: the `file` its `configs` entry gives
  (`benchmark/configs/<config>.json`);
- a traffic mix: `benchmark/traffic/<traffic>.json`, whose `driver` names
  `benchmark/drivers/<driver>.py`;
- a per-layer metric: `benchmark/metrics/<metric>.py`, whose `read(ctx)`
  returns the value or None;
- the limits of a cell's correctness numbers:
  `benchmark/limits/<cell>.json`.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    config: Dict
    traffic: Dict
    limits: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


def sizes_of(config: Dict):
    """The reference's `Sizes` of a configuration file's contents."""
    from reference.model import Sizes

    return Sizes(config["phi"], int(config["num_classes"]), int(config["reg_max"]),
                 tuple(config["input_shape"]))


def load_json(path: Path) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Optional[Path] = None) -> Cell:
    """The cell `name` of `root/BENCHMARK.json` with its parts loaded."""
    root = Path(root or ROOT)
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    bench_dir = root / "benchmark"
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = load_json(bench_dir / "limits" / f"{name}.json")
    return Cell(name, config, traffic, limits, int(w["chips"]),
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def _load_module(path: Path, tag: str) -> ModuleType:
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        f"_bench_{tag}_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(traffic: Dict, root: Optional[Path] = None) -> ModuleType:
    return _load_module(Path(root or ROOT) / "benchmark" / "drivers"
                        / f"{traffic['driver']}.py", "driver")


def metric_reader(name: str, root: Optional[Path] = None) -> ModuleType:
    return _load_module(Path(root or ROOT) / "benchmark" / "metrics" / f"{name}.py",
                        "metric")
