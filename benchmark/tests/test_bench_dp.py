"""The data-parallel train traffic (`drivers/train_dp.py`,
`traffic/train_b64_dp4.json`) as a cell of a tiny benchmark on the CPU: 2
gloo ranks of b2 each, the program in float32.  `BENCHMARK.json` has no
such cell yet (PERF.md §7: its rate spreads too far between processes), so
the tiny copy adds it under the harness's `<traffic>.<config>` name, with
the limits of `train_b16.dcfa-n` and `replica_gap` 0.  A sound run comes
out correct, its ranks end equal and each reports its device to the
harness; each training fault planted in rank 0's process, and the
precision control in the program's place, come out not correct; a traced
run reports none but the cell's metrics.  The ranks outlive a run
(`benchlib/ranks.py`), so the runs share one world."""

from __future__ import annotations

import io
import json
from pathlib import Path

import pytest
import torch

from benchlib import control, faults, harness, spec
from tiny import tiny_root

CELL = "train_b64_dp4.dcfa-n"
BENCH = Path(__file__).resolve().parents[1]
DP_METRICS = ("train_images_per_s", "peak_mem_gib", "idle_share.train",
              "launches_per_step.train")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("tiny"))
    for f in (root / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["compute_dtype"] = "float32"
        f.write_text(json.dumps(cfg))
    t = root / "benchmark" / "traffic" / "train_b64_dp4.json"
    tr = json.loads(t.read_text())
    tr.update(ranks=2, batch=4)
    t.write_text(json.dumps(tr))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "dcfa-n", "traffic": "train_b64_dp4",
                               "chips": 4, "why": "the data-parallel fused step"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "train_b16.dcfa-n" in m.get("workloads", ()) and m["name"] in DP_METRICS:
            m["workloads"].append(CELL)
    bench["per_layer"] += [{"name": n, "unit": u, "better": b, "source": "device_trace",
                            "layer": "train.trainer", "moves": "train_images_per_s",
                            "workloads": [CELL]}
                           for n, u, b in (("allreduce_ms.dp4", "ms", "lower"),
                                           ("allreduce_roofline.dp4", "%", "higher"))]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    limits = json.loads((BENCH / "limits" / "train_b16.dcfa-n.json").read_text())
    (root / "benchmark" / "limits" / f"{CELL}.json").write_text(
        json.dumps(dict(limits, replica_gap=0)))
    return root


def _last_line(root, trace=0):
    out = io.StringIO()
    rc = harness.main(["--workload", CELL, "--seed", "3000000031", "--seconds", "1",
                       "--trace", str(trace)], device="cpu", root=root, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_float32_run_is_correct(root, trace, monkeypatch):
    seen = []
    cards_used = harness.cards_used
    monkeypatch.setattr(harness, "cards_used",
                        lambda cards, chips: seen.append(list(cards)) or cards_used(cards, chips))
    res = _last_line(root, trace)
    # each of the 2 ranks reported the device it stepped on
    assert seen == [[harness.card_of(torch.device("cpu"))] * 2]
    assert res["device"]["count"] == 1
    assert res["correct"] is True
    assert res["checks"]["replica_gap"] == {"value": 0.0, "limit": 0.0}
    cell = spec.load_cell(CELL, root)
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == {"train_images_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_a_planted_fault_is_not_correct(root, fault):
    with faults.planted("train_dp", fault):
        res = _last_line(root)
    assert res["correct"] is False
    if fault == "unchanged":  # rank 0 alone kept its state
        assert res["checks"]["replica_gap"]["value"] == 1.0


def test_the_precision_control_is_not_correct(root):
    c = spec.load_cell(CELL, root)
    got = control.run(c, 3000000033, torch.device("cpu"))
    assert any(got[k] > lim for k, lim in c.limits.items() if k in got), got
