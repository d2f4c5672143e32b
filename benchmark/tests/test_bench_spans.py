"""The program's spans read on a traced window (`benchlib/spans.py`): the
arithmetic on a hand-made trace and span list, and the tiny CPU cells'
traced runs, which report the host-ms metrics beside every metric they
reported before."""

from __future__ import annotations

import io
import json
from pathlib import Path

import pytest
from benchlib import harness, spans
from benchlib.trace import Trace
from tiny import tiny_root

SHIFT_US = 7.5e6  # the trace's clock less the program's


def _trace(ops, ranges, window=(0.0, 10000.0)):
    """ops: (name, start µs, dur µs, correlation, launch µs, launching
    thread); ranges: the benchmark's (label, start µs, end µs)."""
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d,
           "args": {"correlation": c}} for n, ts, d, c, _, _ in ops]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t,
            "dur": 1, "tid": tid, "args": {"correlation": c}} for _, _, _, c, t, tid in ops]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
           for n, a, b in ranges]
    tr = Trace(ev, (window[1] - window[0]) / 1e6, 1,
               labels=("detect", "augment", "train_step", "step"))
    tr.t_lo, tr.t_hi = window
    return tr


def _rec(i, name, a_us, b_us, parent=None, request=1):
    """A span record at trace times [a, b] µs, on the program's clock."""
    return (i, name, int(round((a_us - SHIFT_US) * 1e3)),
            int(round((b_us - SHIFT_US) * 1e3)), parent, request)


def _view(ops, ranges, records, window=(0.0, 10000.0)):
    return spans.SpanView(_trace(ops, ranges, window), records)


def test_self_time_less_nested_children():
    # a step 1000-2000 holding forward 1010-1400 (which holds 1100-1200)
    # and backward 1500-1900
    recs = [_rec(1, "trainer.step", 1000, 2000),
            _rec(2, "trainer.forward", 1010, 1400, parent=1),
            _rec(3, "inner", 1100, 1200, parent=2),
            _rec(4, "trainer.backward", 1500, 1900, parent=1)]
    v = _view([], [("train_step", 1000, 2000)], recs)
    step, fwd = v.of("trainer.step")[0], v.of("trainer.forward")[0]
    assert v.self_us(step) == pytest.approx(1000 - 390 - 400)
    assert v.self_us(fwd) == pytest.approx(390 - 100)
    assert v.host_us(fwd) == pytest.approx(390)
    assert v.per_request_ms("trainer.forward", v.self_us) == pytest.approx(0.29)


def test_device_time_by_correlation_from_any_thread():
    # backward 1500-1900: kernel 1 launched from the main thread at 1510,
    # kernel 2 from the autograd engine's thread at 1600 (both inside it),
    # overlapping on the device; kernel 3 launched at 1950, after it
    ops = [("k1", 1700, 100, 1, 1510, 1), ("k2", 1750, 100, 2, 1600, 2),
           ("k3", 1760, 500, 3, 1950, 1)]
    recs = [_rec(1, "trainer.step", 1000, 2000),
            _rec(2, "trainer.backward", 1500, 1900, parent=1)]
    v = _view(ops, [("train_step", 1000, 2000)], recs)
    assert v.device_us(v.of("trainer.backward")[0]) == pytest.approx(150)
    assert v.device_us(v.of("trainer.step")[0]) == pytest.approx(1760 + 500 - 1700)


def test_idle_inside_a_span():
    # copy_out 3000-4000; the device busy 2900-3200 and 3500-3600: idle 700
    ops = [("a", 2900, 300, 1, 2000, 1), ("b", 3500, 100, 2, 2100, 1)]
    recs = [_rec(1, "predictor.call", 2000, 4100, request=7),
            _rec(2, "predictor.copy_out", 3000, 4000, parent=1, request=7)]
    v = _view(ops, [("detect", 2000, 4105)], recs)
    assert v.idle_us(v.of("predictor.copy_out")[0]) == pytest.approx(700)
    assert spans.copy_out_idle_ms({"trace": v.trace, "spans": v}) == pytest.approx(0.7)
    split = v.idle_split()
    assert split["window"] == pytest.approx(10000 - 400)
    assert split["inside"] + split["outside"] == pytest.approx(split["window"])


def test_replay_device_time_by_correlation_or_none():
    # the graph's kernels share the correlation id of the launch made inside
    # the replay; a kernel launched elsewhere is not the replay's
    ops = [("g1", 2300, 100, 10, 2150, 1), ("g2", 2500, 200, 10, 2150, 1),
           ("late", 5000, 50, 12, 9999, 1)]
    recs = [_rec(1, "predictor.call", 2000, 3000),
            _rec(2, "pipeline.replay", 2100, 2200, parent=1),
            _rec(3, "predictor.copy_out", 2200, 2900, parent=1)]
    v = _view(ops, [("detect", 1990, 3010)], recs)
    assert v.replay_device_ms() == pytest.approx(0.3)
    # a trace that ties no kernel to a launch inside the replay reads None
    ops = [(n, ts, d, c, 9999, 1) for n, ts, d, c, _, _ in ops]
    v = _view(ops, [("detect", 1990, 3010)], recs)
    assert v.replay_device_ms() is None
    assert spans.replay_device_ms({"trace": v.trace, "spans": v}) is None


@pytest.mark.parametrize("lag_us", [(3, 3, 3), (2, 3, 40)])
def test_the_ranges_bound_the_offset(lag_us):
    # three calls; each root span starts lag µs after its benchmark range,
    # so the least lag places them closest; an older window's span
    # (another process's trace) is left out
    ranges = [("detect", 1000 + 2000 * k, 2500 + 2000 * k) for k in range(3)]
    recs = [_rec(k + 1, "predictor.call", a + lag, b - 5, request=k + 1)
            for k, ((_, a, b), lag) in enumerate(zip(ranges, lag_us))]
    recs.insert(0, _rec(99, "predictor.call", -9e5, -8e5))
    v = _view([], ranges, recs)
    assert v.offset_us == pytest.approx(SHIFT_US - min(lag_us), abs=1e-3)
    assert v.anchors == (3, 0) and len(v.of("predictor.call")) == 3
    assert v.residual_us is None  # no replay: no upper bound


def test_a_short_root_keeps_its_own_range():
    # two 300 µs ranges 200 µs apart; the first root lasts 90 µs, so the
    # next range starts well within SLACK_US of it
    ranges = [("augment", 1000, 1300), ("augment", 1500, 1800)]
    recs = [_rec(1, "device_aug.batch", 1010, 1100, request=1),
            _rec(2, "device_aug.batch", 1520, 1600, request=2)]
    v = _view([], ranges, recs)
    assert v.offset_us == pytest.approx(SHIFT_US - 10, abs=1e-3)
    assert v.anchors == (2, 0)


def test_graph_launches_bound_the_offset():
    # the root spans start 40, 4 and 40 µs after their benchmark ranges
    # (lower bound: 4 µs early); each replay's graph launch (the launch its
    # two kernels name) comes 2, 6 and 3 µs into it (upper bound: 2 µs
    # late), which places the spans; a copy's launch, with one operation,
    # bounds nothing
    ranges, recs, ops = [], [], []
    for k, (lag, late) in enumerate(zip((40, 4, 40), (2, 6, 3))):
        a = 1000 + 2000 * k
        ranges.append(("detect", a, a + 1500))
        c = 10 * k
        recs += [_rec(c + 1, "predictor.call", a + lag, a + 1495, request=k + 1),
                 _rec(c + 2, "pipeline.copy_in", a + 50, a + 290, parent=c + 1, request=k + 1),
                 _rec(c + 3, "pipeline.replay", a + 300, a + 900, parent=c + 1, request=k + 1)]
        ops += [("h2d", a + 280, 10, c + 1, a + 285, 1),
                ("g1", a + 400, 100, c + 2, a + 300 + late, 1),
                ("g2", a + 500, 50, c + 2, a + 300 + late, 1)]
    v = _view(ops, ranges, recs)
    assert v.offset_us == pytest.approx(SHIFT_US + 2, abs=1e-3)
    assert v.anchors == (3, 3) and v.residual_us == pytest.approx(6, abs=1e-3)
    for sp in v.of("pipeline.replay"):
        assert v.device_us(sp) == pytest.approx(150)
    for sp in v.of("pipeline.copy_in"):
        assert v.device_us(sp) == pytest.approx(10)


def test_no_spans_read_none():
    tr = _trace([("k", 10, 5, 1, 5, 1)], [("detect", 0, 100)])
    for read in (spans.copy_in_idle_ms, spans.replay_device_ms, spans.augment_host_ms):
        assert read({"trace": tr, "spans": None}) is None
        assert read({}) is None


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The tiny benchmark, and a copy without the per-layer metrics that
    read the program's spans."""
    new = tiny_root(tmp_path_factory.mktemp("new"))
    old = tiny_root(tmp_path_factory.mktemp("old"))
    bench = json.loads((old / "BENCHMARK.json").read_text())
    bench["per_layer"] = [m for m in bench["per_layer"] if "benchlib.spans" not in (
        old / "benchmark" / "metrics" / f"{m['name']}.py").read_text()]
    (old / "BENCHMARK.json").write_text(json.dumps(bench))
    return new, old


def _metrics(root: Path, cell: str) -> dict:
    out = io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", "3000000007", "--seconds", "1",
                       "--trace", "1"], device="cpu", root=root, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])["metrics"]


@pytest.mark.parametrize("cell,host", [
    ("serve_b1.dcfa-n", set()),
    ("train_b16.dcfa-n", {"augment_host_ms.train"})])
def test_tiny_cells_report_the_host_metrics(roots, cell, host):
    new, old = roots
    got, before = _metrics(new, cell), _metrics(old, cell)
    assert set(got) == set(before) | host
    assert all(got[m]["value"] > 0 for m in host)
