"""The port stands alone: no module of dcfa_yolo_tpu_torch (nor chip_smoke.py)
imports JAX or the JAX package, and entry points do not fall back to the CPU
when CUDA is missing."""

from __future__ import annotations

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dcfa_yolo_tpu_torch

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import dcfa_yolo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dcfa_yolo_tpu_torch.__path__,
                                               'dcfa_yolo_tpu_torch.')]
for name in names + ['chip_smoke']:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'dcfa_yolo_tpu'))
if bad:
    print('IMPORTED', bad)
    sys.exit(1)
print(len(names))
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    expected = len(list(pkgutil.walk_packages(dcfa_yolo_tpu_torch.__path__,
                                              "dcfa_yolo_tpu_torch.")))
    assert n_modules == expected and n_modules >= 15


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "CUDA is not available" in proc.stderr


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device is usable")
    from dcfa_yolo_tpu_torch.config import ModelConfig
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
    from dcfa_yolo_tpu_torch.models.yolo import init_model

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YOLOPredictor(["obj"], input_shape=(64, 64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_model(ModelConfig(input_shape=(64, 64)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_model(ModelConfig(input_shape=(64, 64)), train=True)
    # the explicit CPU request works
    pred = YOLOPredictor(["obj"], input_shape=(64, 64), device="cpu")
    assert pred.device.type == "cpu"


def test_trainer_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device is usable")
    from dcfa_yolo_tpu_torch.config import ModelConfig
    from dcfa_yolo_tpu_torch.models.yolo import init_model
    from dcfa_yolo_tpu_torch.train.trainer import Trainer

    model = init_model(ModelConfig(input_shape=(64, 64)), device="cpu", train=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(model)
    assert Trainer(model, device="cpu").device.type == "cpu"


def test_measurement_entry_points_raise_without_cuda(monkeypatch):
    """The bench, the summary and the stem split probe run on the card unless
    asked for the CPU (BENCH_DEVICE=cpu, --device cpu)."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device is usable")
    from dcfa_yolo_tpu_torch import bench, summary
    from dcfa_yolo_tpu_torch.tools import stem_split_probe

    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    monkeypatch.setenv("BENCH_SIZE", "64")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stem_split_probe.main(["1", "--size", "32"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        summary.main(["--input-shape", "64", "64"])


def test_walk_covers_the_training_cli_modules():
    """The import probe above walks every module of the package, the host
    data path, the mAP harness, the utilities, the tools, the weight
    importer and exporter, the training CLI's `__main__`, the flat tail and
    the data-parallel modules included."""
    names = {m.name for m in pkgutil.walk_packages(dcfa_yolo_tpu_torch.__path__,
                                                   "dcfa_yolo_tpu_torch.")}
    for name in ("data.augment", "data.loader", "data.voc",
                 "evalmap.voc_map", "evalmap.coco_map", "utils.callbacks",
                 "utils.checkpoint", "utils.profiling", "tools.make_synth_dataset",
                 "tools.loader_bench",
                 "train.__main__", "predict", "get_map", "ops.consts",
                 "utils.golden", "models.torch_import", "models.torch_export",
                 "tools.export", "train.flat_opt", "parallel.mesh", "parallel.fused_check",
                 "parallel.serve", "parallel.dryrun"):
        assert f"dcfa_yolo_tpu_torch.{name}" in names


def test_training_cli_raises_without_cuda(tmp_path):
    """`python -m dcfa_yolo_tpu_torch.train` runs on the card unless
    `--device cpu` is passed; without a card it fails, in a fresh process
    and in-process."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device is usable")
    proc = subprocess.run([sys.executable, "-m", "dcfa_yolo_tpu_torch.train",
                           "--save-dir", str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    from dcfa_yolo_tpu_torch.train.__main__ import run

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["--save-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("cli", ["predict", "get_map"])
def test_serving_clis_raise_without_cuda(tmp_path, cli):
    """`python -m dcfa_yolo_tpu_torch.predict` and `.get_map` run on the card
    unless `--device cpu` is passed; without a card they fail, in a fresh
    process and in-process, before writing any output."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device is usable")
    import importlib

    (tmp_path / "classes.txt").write_text("obj\n")
    argv = ["--input-shape", "64", "64", "--classes-path", str(tmp_path / "classes.txt")]
    if cli == "predict":
        argv += ["--mode", "predict", "--output", str(tmp_path / "out.png"),
                 "--rgb", str(REPO / "img" / "sample_rgb.png"),
                 "--nir", str(REPO / "img" / "sample_nir.png")]
    else:
        sets = tmp_path / "VOCdevkit" / "VOC2007" / "ImageSets" / "Main"
        sets.mkdir(parents=True)
        (sets / "test.txt").write_text("000000\n")
        argv += ["--map-mode", "1", "--vocdevkit-path", str(tmp_path / "VOCdevkit"),
                 "--map-out-path", str(tmp_path / "map_out")]
    proc = subprocess.run([sys.executable, "-m", f"dcfa_yolo_tpu_torch.{cli}"] + argv,
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        importlib.import_module(f"dcfa_yolo_tpu_torch.{cli}").run(argv)
    assert not (tmp_path / "out.png").exists()
    assert not any((tmp_path / "map_out" / "detection-results").glob("*.txt"))
