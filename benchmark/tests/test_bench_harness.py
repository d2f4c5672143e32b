"""The harness on the CPU at a tiny size: cells, traffic mixes and
per-layer metrics found by name (a new one of each added as files, no
existing file edited), seeded inputs, the result line's keys, and its
`device` block counted from the cards the run's processes report."""

from __future__ import annotations

import io
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchlib import harness, spec, synth, weights
from reference.model import Sizes, state_names
from tiny import tiny_root


def _run(root: Path, cell: str, trace: int, seconds: float = 1.0, seed: int = 3000000007):
    out = io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu", root=root, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_cells_are_found_by_name():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.name == f"{w['traffic']}.{w['config']}"
        assert spec.driver(cell.traffic).run
        for m in cell.per_layer:
            assert spec.metric_reader(m["name"]).read


def test_a_new_config_traffic_and_metric_are_added_as_files(tmp_path):
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    cfg = json.loads((root / "benchmark/configs/dcfa-n.json").read_text())
    cfg["name"] = "dcfa-n.copy"
    (root / "benchmark/configs/dcfa-n.copy.json").write_text(json.dumps(cfg))
    t = json.loads((root / "benchmark/traffic/serve_b1.json").read_text())
    t["conf"] = 0.25
    (root / "benchmark/traffic/serve_low_conf.json").write_text(json.dumps(t))
    (root / "benchmark/metrics/calls_traced.py").write_text(
        '"""Calls in the traced window."""\n\n\n'
        "def read(ctx):\n    return ctx['trace'].n_calls if ctx.get('trace') else None\n")
    (root / "benchmark/limits/serve_low_conf.dcfa-n.copy.json").write_text(
        json.dumps({"det_gap": 0.05, "nms_tol": 0.002, "nms_miss": 0, "nms_overlap": 0}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dcfa-n.copy", "source": "https://example.org",
                             "file": "benchmark/configs/dcfa-n.copy.json", "reduced": [],
                             "why": "a copy"})
    bench["workloads"].append({"name": "serve_low_conf.dcfa-n.copy", "config": "dcfa-n.copy",
                               "traffic": "serve_low_conf", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "latency_p95_ms",
                               "workloads": ["serve_low_conf.dcfa-n.copy"]})
    for m in bench["end_to_end"]:
        if m["name"] == "latency_p95_ms":
            m["workloads"].append("serve_low_conf.dcfa-n.copy")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = _run(root, "serve_low_conf.dcfa-n.copy", trace=1)
    assert res["metrics"]["calls_traced"]["value"] == 2
    assert res["correct"] is True
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no existing file of the harness was edited


def test_serving_inputs_are_seeded():
    from drivers.serve import make_pool

    a, b, c = (make_pool(s, 2, 1, (8, 8)) for s in (3000000011, 3000000011, 3000000012))
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_training_data_is_seeded(tmp_path):
    paths = []
    for i, seed in enumerate((3000000011, 3000000011, 3000000012)):
        d = tmp_path / str(i)
        d.mkdir()
        lines = synth.write_dataset(str(d), 3, (48, 64), seed)
        paths.append(([l.split()[2:] for l in lines],
                      [Path(p).read_bytes() for l in lines for p in l.split()[:2]]))
    assert paths[0] == paths[1] and paths[0] != paths[2]


@pytest.mark.parametrize("kind", ["serving", "training"])
def test_weights_are_seeded(kind):
    names = state_names(Sizes("n", 1, 16, (64, 64)))
    a, b, c = (weights.make_state(names, s, kind, "cpu") for s in (2**31 + 5, 2**31 + 5, 7))
    assert all(torch.equal(a[k], b[k]) for k in a)
    if kind == "serving":
        assert not all(torch.equal(a[k], c[k]) for k in a)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", ["serve_b1.dcfa-n", "train_b16.dcfa-s", "train_b16.dcfa-n"])
@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line(root, cell, trace):
    res = _run(root, cell, trace)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(res["correct"], bool) and res["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    assert (res["device"]["count"], res["device"]["kind"]) == (1, "cpu")
    bench = spec.load_cell(cell, root)
    want = bench.per_layer if trace else bench.end_to_end
    names = {m["name"] for m in want}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names and "setup_s" in names
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


H100 = "NVIDIA H100 80GB HBM3"


def _cards(uuids, names=None):
    """What the processes of a run on cards report (`harness.card_of`)."""
    return [{"index": i, "name": n, "uuid": u}
            for i, (u, n) in enumerate(zip(uuids, names or [H100] * len(uuids)))]


@pytest.mark.parametrize("cards,count", [
    (_cards(["GPU-a", "GPU-b", "GPU-c", "GPU-d"]), 4),
    (_cards(["GPU-a", "GPU-a", "GPU-b", "GPU-c"]), None),  # two ranks on one card
    (_cards(["GPU-a", "GPU-b", "GPU-c", "GPU-d"], [H100] * 3 + ["NVIDIA A100-SXM4-80GB"]),
     None)])
def test_the_device_block_counts_the_cards_that_ran(tmp_path, monkeypatch, cards, count):
    """A four-card cell's line counts the distinct cards its processes ran
    on; fewer than the cell asks for, or cards of two kinds, give no line
    and a non-zero exit.  The driver is a stand-in that reports `cards`."""
    root = tiny_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        if w["name"] == "serve_b1.dcfa-n":
            w["chips"] = 4
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    def run(ctx):
        return harness.Outcome({"latency_p95_ms": 5.0, "setup_s": 10.0}, 1, 0, {}, 2**30, cards)

    monkeypatch.setattr(spec, "driver", lambda traffic, root=None: SimpleNamespace(run=run))
    out = io.StringIO()
    rc = harness.main(["--workload", "serve_b1.dcfa-n", "--seed", "3000000041", "--seconds",
                       "1", "--trace", "0"], device="cuda", root=root, out=out)
    if count is None:
        assert rc != 0 and out.getvalue() == ""
    else:
        assert rc == 0
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        assert res["device"] == {"platform": "gpu", "kind": H100, "count": count,
                                 "memory_peak_bytes": 2**30}
