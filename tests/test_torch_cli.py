"""The port's serving CLIs (`python -m dcfa_yolo_tpu_torch.predict` and
`.get_map`) in-process on the CPU at 64² on a synthetic dataset: every
predict mode, get_map's modes 0-4 (ground truth and VOC mAP held against
the root get_map.py's), the caps' auto-raise and `--no-auto-raise`, the
JAX backend names and `--pair-backbones`."""

from __future__ import annotations

import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dcfa_yolo_tpu_torch import get_map, predict
from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.data import voc
from dcfa_yolo_tpu_torch.models.yolo import init_model
from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset
from dcfa_yolo_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """6 synthetic 160×120 pairs (3 in test), a port checkpoint of
    `init_model(seed=0)` weights at 64², and the pairs as img/{rgb,nir}."""
    d = tmp_path_factory.mktemp("cli")
    make_dataset(str(d), 6, (160, 120))
    devkit = d / "VOCdevkit"
    voc.generate_imagesets(str(devkit), trainval_percent=0.5, train_percent=0.5)
    model = init_model(ModelConfig(num_classes=1, phi="n", input_shape=(64, 64)), 0, "cpu")
    sd = model.state_dict()
    buffers = {k for k, _ in model.named_buffers()}
    save_checkpoint(str(d / "w.ckpt"), dict(
        params={k: v for k, v in sd.items() if k not in buffers},
        batch_stats={k: v for k, v in sd.items() if k in buffers},
        ema={}, opt_state={}, ema_updates=0, epoch=0))
    for sub in ("rgb", "nir"):
        shutil.copytree(devkit / "VOC2007" / f"JPEGImages_{sub}", d / "img" / sub)
    return d


def _model_args(d):
    return ["--device", "cpu", "--input-shape", "64", "64", "--model-path",
            str(d / "w.ckpt"), "--classes-path", str(d / "model_data" / "voc_classes.txt")]


def _pair(d):
    return ["--rgb", str(d / "img" / "rgb" / "000000.png"),
            "--nir", str(d / "img" / "nir" / "000000.png")]


@pytest.mark.parametrize("mode", ["predict", "fps", "heatmap"])
def test_predict_modes(data, tmp_path, mode):
    argv = ["--mode", mode, "--confidence", "0.01", "--test-interval", "2",
            "--output", str(tmp_path / "p.png"),
            "--heatmap-save-path", str(tmp_path / "h.png")] + _pair(data) + _model_args(data)
    out = predict.run(argv)
    assert out["mode"] == mode
    if mode == "fps":
        assert out["seconds"] > 0
    else:
        assert os.path.getsize(out["saved"]) > 0


@pytest.mark.parametrize("batch", [1, 4])
def test_predict_dir_predict(data, tmp_path, batch):
    """Per image, and at --batch-size 4 over 6 pairs: a full batch and a
    ragged one padded; every image annotated once."""
    out = predict.run(["--mode", "dir_predict", "--dir-origin-path", str(data / "img"),
                       "--dir-save-path", str(tmp_path), "--batch-size", str(batch),
                       "--confidence", "0.01"] + _model_args(data))
    assert out["names"] == [f"{i:06d}.png" for i in range(6)]
    assert sorted(os.listdir(tmp_path)) == out["names"]


def test_predict_dir_batched_equals_per_image(data, tmp_path):
    """The batched dir_predict draws the same images as the per-image one."""
    from PIL import Image

    import numpy as np

    for b in (1, 4):
        predict.run(["--mode", "dir_predict", "--dir-origin-path", str(data / "img"),
                     "--dir-save-path", str(tmp_path / f"b{b}"), "--batch-size", str(b),
                     "--confidence", "0.01"] + _model_args(data))
    for name in os.listdir(tmp_path / "b1"):
        a, b = (np.asarray(Image.open(tmp_path / d / name)) for d in ("b1", "b4"))
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("nms,stem", [("xla", "xla"), ("pallas", "pallas_e"),
                                      ("pallas_d", "pallas_d"), ("kernel", "plain")])
def test_jax_backend_names_accepted(data, tmp_path, monkeypatch, nms, stem):
    """--nms-backend and --stem-backend take the JAX names; bf16 so that the
    kernel stem fits.  The names reach the predictor as the port's."""
    from dcfa_yolo_tpu_torch.infer import predictor as predictor_mod

    seen = {}
    orig = predictor_mod.YOLOPredictor.__init__

    def spy(self, *a, **kw):
        seen.update(nms=kw["nms"], stem=kw["stem"])
        orig(self, *a, **kw)

    monkeypatch.setattr(predictor_mod.YOLOPredictor, "__init__", spy)
    predict.run(["--mode", "predict", "--nms-backend", nms, "--stem-backend", stem,
                 "--compute-dtype", "bfloat16", "--output", str(tmp_path / "p.png")]
                + _pair(data) + _model_args(data))
    assert seen == dict(nms=predict.NMS_NAMES[nms], stem=stem)
    assert seen["nms"] == ("plain" if nms == "xla" else "kernel")


def test_pair_backbones_raises_naming_the_item(data, tmp_path, monkeypatch):
    """--pair-backbones serves the paired graph (it implies --fold-shuffle):
    predict draws, and get_map writes, the detections of the same run with
    --fold-shuffle, float32: the same counts and classes, boxes within 1 px,
    scores within 1e-3 (tests/test_pair_backbones.py:198-202); in the
    detection files scores as printed, truncated to 4 decimals (1.1e-3) and
    corners truncated by int() (1 px).  (The name is kept from when the
    flag raised.)"""
    from dcfa_yolo_tpu_torch.infer import predictor as predictor_mod

    drawn = []
    orig = predictor_mod.YOLOPredictor.draw_detections

    def spy(self, image, boxes, scores, labels):
        drawn.append((self.model.pair_backbones, self.model.fold_shuffle,
                      boxes, scores, labels))
        return orig(self, image, boxes, scores, labels)

    monkeypatch.setattr(predictor_mod.YOLOPredictor, "draw_detections", spy)
    f32 = ["--compute-dtype", "float32"]
    lines = {}
    for flag in ("--fold-shuffle", "--pair-backbones"):
        predict.run(["--mode", "predict", "--confidence", "0.01", "--output",
                     str(tmp_path / "p.png"), flag] + f32 + _pair(data) + _model_args(data))
        out = tmp_path / flag
        get_map.run(["--map-mode", "1", flag] + f32 + _gm_args(data, out))
        lines[flag] = {f.name: f.read_text().splitlines()
                       for f in sorted((out / "detection-results").iterdir())}
    (p0, f0, b0, s0, c0), (p1, f1, b1, s1, c1) = drawn
    assert (p0, f0, p1, f1) == (False, True, True, True)
    assert len(s0) == len(s1) > 0
    np.testing.assert_array_equal(c0, c1)
    assert np.abs(b0 - b1).max() <= 1.0 and np.abs(s0 - s1).max() < 1e-3
    fold, pair = lines["--fold-shuffle"], lines["--pair-backbones"]
    assert fold.keys() == pair.keys() and sum(map(len, fold.values())) > 0
    for name in fold:
        assert len(fold[name]) == len(pair[name])
        for a, b in zip(fold[name], pair[name]):
            a, b = a.split(), b.split()
            assert a[0] == b[0] and abs(float(a[1]) - float(b[1])) <= 1.1e-3
            assert all(abs(int(x) - int(y)) <= 1 for x, y in zip(a[2:], b[2:]))


def _gm_args(data, out):
    return _model_args(data) + ["--vocdevkit-path", str(data / "VOCdevkit"),
                                "--map-out-path", str(out)]


def _run_root_get_map(monkeypatch, argv):
    """The root get_map.py (the JAX package's CLI) in-process, without its
    persistent XLA cache (a directory under HOME and a process-wide JAX
    setting)."""
    from dcfa_yolo_tpu.utils import jaxcache

    monkeypatch.setattr(jaxcache, "enable_persistent_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["get_map.py"] + argv)
    sys.path.insert(0, str(REPO))
    try:
        import get_map as root_get_map

        root_get_map.main()
    finally:
        sys.path.remove(str(REPO))


def test_get_map_modes(data, tmp_path, monkeypatch, capsys):
    """Modes 1, 2, 3 and 4 in turn on one output directory, then mode 0 on
    a fresh one: the same detection files, ground truth and mAP; ground
    truth equals the root CLI's byte for byte, and the VOC mAP equals the
    JAX package's on the same files."""
    from dcfa_yolo_tpu.evalmap.voc_map import get_map as jax_get_map

    step = tmp_path / "steps"
    r1 = get_map.run(["--map-mode", "1"] + _gm_args(data, step))
    assert r1["attempts"][-1]["images"] == 3
    get_map.run(["--map-mode", "2"] + _gm_args(data, step))
    r3 = get_map.run(["--map-mode", "3"] + _gm_args(data, step))
    r4 = get_map.run(["--map-mode", "4"] + _gm_args(data, step))
    assert 0.0 <= r3["voc_map"] <= 1.0 and 0.0 <= r4["coco_ap"] <= r4["coco_ap50"] <= 1.0
    whole = tmp_path / "whole"
    r0 = get_map.run(["--map-mode", "0"] + _gm_args(data, whole))
    assert r0["voc_map"] == r3["voc_map"]
    ids = (data / "VOCdevkit" / "VOC2007" / "ImageSets" / "Main" / "test.txt").read_text().split()
    for sub in ("detection-results", "ground-truth"):
        for i in ids:
            assert (step / sub / f"{i}.txt").read_text() == (whole / sub / f"{i}.txt").read_text()
    root = tmp_path / "root"
    _run_root_get_map(monkeypatch, ["--map-mode", "2", "--vocdevkit-path",
                                    str(data / "VOCdevkit"), "--map-out-path", str(root),
                                    "--classes-path",
                                    str(data / "model_data" / "voc_classes.txt")])
    for i in ids:
        assert (root / "ground-truth" / f"{i}.txt").read_text() == \
            (whole / "ground-truth" / f"{i}.txt").read_text()
    assert jax_get_map(0.5, False, score_threshold=0.5, path=str(whole)) == r0["voc_map"]


def test_get_map_auto_raise_and_no_auto_raise(data, tmp_path):
    """A binding --pre-nms-topk 4 is doubled past the largest candidate
    count and the pass redone, with batched eval (3 test pairs at
    --batch-size 2: a ragged group padded); --no-auto-raise fails."""
    out = get_map.run(["--map-mode", "1", "--pre-nms-topk", "4", "--batch-size", "2"]
                      + _gm_args(data, tmp_path / "a"))
    first, last = out["attempts"][0], out["attempts"][-1]
    assert first["pre_nms_topk"] == 4 and first["topk_bound"] > 0
    assert len(out["attempts"]) == 2 and not last["topk_bound"]
    assert last["pre_nms_topk"] > first["max_candidates"] >= last["pre_nms_topk"] // 2
    with pytest.raises(SystemExit) as e:
        get_map.run(["--map-mode", "1", "--pre-nms-topk", "4", "--no-auto-raise"]
                    + _gm_args(data, tmp_path / "b"))
    assert e.value.code not in (None, 0) and "caps" in str(e.value.code)
