"""The comparison that decides `correct`, shown to fail: a whole run with
the look for a card skipped, at a tiny size on the CPU, (a) with each
fault the cell can have planted under the timed path, and (b) with the
precision control (the reference at fp8) in the program's place.  Each
must come out not correct under the cell's own limits.  The tiny cells run
the program in float32, where a sound run reads at rounding level and
comes out correct, so that what fails a faulty run is the fault."""

from __future__ import annotations

import io
import json

import pytest
import torch

from benchlib import control, faults, harness, spec
from tiny import tiny_root

CELLS = ["serve_b1.dcfa-n", "train_b16.dcfa-n", "train_b16.dcfa-s"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("tiny"))
    for f in (root / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["compute_dtype"] = "float32"
        f.write_text(json.dumps(cfg))
    return root


def _last_line(root, cell):
    out = io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", "3000000021", "--seconds", "1",
                       "--trace", "0"], device="cpu", root=root, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_float32_run_is_correct(root, cell):
    assert _last_line(root, cell)["correct"] is True


def _cases():
    out = []
    for name in CELLS:
        cell = spec.load_cell(name)
        out += [(name, f) for f in faults.applicable(cell)]
    return out


@pytest.mark.parametrize("cell,fault", _cases())
def test_a_planted_fault_is_not_correct(root, cell, fault):
    kind = spec.load_cell(cell, root).traffic["driver"]
    with faults.planted(kind, fault):
        assert _last_line(root, cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_the_precision_control_is_not_correct(root, cell):
    c = spec.load_cell(cell, root)
    got = control.run(c, 3000000023, torch.device("cpu"))
    assert any(got[k] > lim for k, lim in c.limits.items()), got
