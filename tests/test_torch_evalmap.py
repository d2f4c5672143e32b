"""The port's mAP harness (dcfa_yolo_tpu_torch/evalmap/) against the
reference goldens (tests/goldens/map_golden.json, map_results_golden.txt,
as tests/test_eval.py holds the JAX package's) and against the JAX
package's own functions on the same directories."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

from dcfa_yolo_tpu.evalmap.coco_map import get_coco_map as jax_coco_map
from dcfa_yolo_tpu.evalmap.voc_map import get_map as jax_get_map
from dcfa_yolo_tpu_torch.evalmap import get_coco_map, get_map

GOLDEN_DIR = Path(__file__).parent / "goldens"


@pytest.fixture
def work(tmp_path):
    dst = tmp_path / "map"
    shutil.copytree(GOLDEN_DIR / "map_files", dst)
    return dst


def test_voc_map_matches_reference_golden(work):
    ref = json.loads((GOLDEN_DIR / "map_golden.json").read_text())["map50"]
    mine = get_map(0.5, False, score_threshold=0.5, path=str(work))
    np.testing.assert_allclose(mine, ref, atol=1e-10)


def test_results_txt_matches_reference_golden(work):
    """The same facts as the reference's results.txt: per-class AP, rounded
    precision and recall arrays, gt counts, detection counts with tp/fp."""
    get_map(0.5, False, score_threshold=0.5, path=str(work))
    mine = (work / "results" / "results.txt").read_text()
    ref = (GOLDEN_DIR / "map_results_golden.txt").read_text()

    def facts(txt):
        ap = {cls: v for v, cls in re.findall(r"^([\d.]+)% = (\S+) AP", txt, re.M)}
        prec = re.findall(r"Precision: (\[[^\]]*\])", txt)
        rec = re.findall(r"Recall :(\[[^\]]*\])", txt)
        m = re.search(r"mAP = ([\d.]+)%", txt)
        gts = dict(re.findall(r"^(\S+): (\d+)$", txt, re.M))
        dets = dict(re.findall(r"^(\S+): (\d+ \(tp:\d+, fp:\d+\))$", txt, re.M))
        return ap, prec, rec, m.group(1), gts, dets

    assert facts(mine) == facts(ref)


@pytest.mark.parametrize("min_overlap", [0.5, 0.75])
def test_voc_map_equals_jax(tmp_path, min_overlap):
    for name in ("port", "jax"):
        shutil.copytree(GOLDEN_DIR / "map_files", tmp_path / name)
    mine = get_map(min_overlap, False, path=str(tmp_path / "port"))
    ref = jax_get_map(min_overlap, False, path=str(tmp_path / "jax"))
    assert mine == ref
    assert ((tmp_path / "port" / "results" / "results.txt").read_text()
            == (tmp_path / "jax" / "results" / "results.txt").read_text())


def test_coco_map_equals_jax(work):
    classes = sorted({line.split()[0] for f in (work / "ground-truth").glob("*.txt")
                      for line in f.read_text().splitlines() if line.strip()})
    assert get_coco_map(classes, path=str(work)) == jax_coco_map(classes, path=str(work))


def test_coco_map_on_perturbed_detections_equals_jax(work):
    """Detections with shifted boxes and scores (ties included) give the
    same AP@[.5:.95] and AP50 as the JAX harness."""
    rng = np.random.default_rng(0)
    for f in sorted((work / "detection-results").glob("*.txt")):
        out = []
        for line in f.read_text().splitlines():
            cls, score, *xyxy = line.split()
            xyxy = [str(int(float(v)) + int(rng.integers(-3, 4))) for v in xyxy]
            score = f"{round(float(score) * 4) / 4:.4f}"
            out.append(" ".join([cls, score, *xyxy]))
        f.write_text("\n".join(out) + "\n")
    classes = sorted({line.split()[0] for f in (work / "ground-truth").glob("*.txt")
                      for line in f.read_text().splitlines() if line.strip()})
    mine = get_coco_map(classes, path=str(work))
    assert mine == jax_coco_map(classes, path=str(work))
    assert 0.0 <= mine[1] <= 1.0
