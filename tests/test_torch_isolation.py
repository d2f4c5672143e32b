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
    # the explicit CPU request works
    pred = YOLOPredictor(["obj"], input_shape=(64, 64), device="cpu")
    assert pred.device.type == "cpu"
