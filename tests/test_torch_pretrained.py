"""The port's initial weights against the JAX package's: `--pretrained` /
`--model-dir` (the reference's backbone file, never downloaded, imported
into both backbones), `--model-path` over the JAX model's initial state,
and that state itself (`flax_default_init` against `init_model`).

Tolerances: the import, the counts, biases, BN and BiFPN are exact; the
conv kernels of `flax_default_init` match JAX's in distribution only
(jax.random cannot be reproduced without JAX): each leaf of at least 4096
elements within 10% of JAX's standard deviation, every value within ±2
truncated standard deviations.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from dcfa_yolo_tpu.config import ModelConfig as JaxModelConfig
from dcfa_yolo_tpu.models.torch_import import import_state_dict as jax_import_state_dict
from dcfa_yolo_tpu.models.yolo import init_model as jax_init_model
from dcfa_yolo_tpu.utils.checkpoint import load_variables as jax_load_variables
from dcfa_yolo_tpu.utils.general import download_weights as jax_download_weights
from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.data import voc
from dcfa_yolo_tpu_torch.models.convert import from_jax_variables
from dcfa_yolo_tpu_torch.models.torch_import import (import_state_dict, load_torch_checkpoint,
                                                     reference_key_to_port)
from dcfa_yolo_tpu_torch.models.reparam import unfold_shuffle_state_dict
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo
from dcfa_yolo_tpu_torch.ops.norm import BatchNorm
from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset
from dcfa_yolo_tpu_torch.train.__main__ import load_initial_weights, parse_args, run
from dcfa_yolo_tpu_torch.train.init_weights import flax_default_init
from dcfa_yolo_tpu_torch.train.trainer import Trainer
from dcfa_yolo_tpu_torch.utils.general import download_weights
from dcfa_yolo_tpu_torch.utils.golden import load_manifest, synth_state_dict

torch.set_num_threads(1)
MANIFEST = Path(__file__).resolve().parent / "goldens" / "manifest.json"
CFG = dict(num_classes=1, phi="n", input_shape=(64, 64))
TRUNC_STD = 0.87962566103423978


@pytest.fixture(scope="module")
def jax_variables():
    """The JAX model's initial state at 64², `init_model(cfg, PRNGKey(0))`."""
    return jax_init_model(JaxModelConfig(**CFG), jax.random.PRNGKey(0))[1]


@pytest.fixture(scope="module")
def backbone():
    """The reference's single-modal backbone file's contents: the
    synthesized `backbone_rgb.*` entries of the golden manifest, unprefixed
    (the Backbone module's own key space)."""
    sd = synth_state_dict(load_manifest(str(MANIFEST)), seed=0)
    return {k[len("backbone_rgb."):]: v for k, v in sd.items()
            if k.startswith("backbone_rgb.")}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    make_dataset(str(d), 6, (160, 120))
    devkit = str(d / "VOCdevkit")
    voc.generate_imagesets(devkit, trainval_percent=1.0, train_percent=0.67)
    classes = str(d / "model_data" / "voc_classes.txt")
    voc.generate_annotation_files(devkit, classes, out_dir=str(d), image_ext=".png")
    return d


def _args(d, save_dir, *extra):
    return ["--classes-path", str(d / "model_data" / "voc_classes.txt"),
            "--train-annotation", str(d / "2007_train.txt"),
            "--val-annotation", str(d / "2007_val.txt"),
            "--input-shape", "64", "64", "--batch-size", "2", "--compute-dtype", "float32",
            "--num-workers", "1", "--save-dir", str(save_dir), "--device", "cpu", *extra]


def _model_dir(tmp_path, backbone, phi="n"):
    d = tmp_path / "model_data"
    d.mkdir()
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in backbone.items()},
               d / f"yolov8_{phi}_backbone_weights.pth")
    return d


def _first_step_weights(monkeypatch):
    """Patch `Trainer.train_step` to keep the weights the trainer holds when
    its first step starts, unfolded to the canonical train graph; returns
    the list that receives them."""
    seen = []
    real = Trainer.train_step

    def step(self, *a, **k):
        if not seen:
            st = self.state
            sd = {n: t.detach().cpu().clone()
                  for n, t in {**st.params, **st.batch_stats}.items()}
            seen.append(unfold_shuffle_state_dict(sd) if self.model.fold_shuffle else sd)
        return real(self, *a, **k)

    monkeypatch.setattr(Trainer, "train_step", step)
    return seen


def _initial(argv, say=lambda *a, **k: None):
    """`load_initial_weights` over a fresh 64² model: (state_dict, report)."""
    model = DCFAYolo(ModelConfig(**CFG))
    report = load_initial_weights(parse_args(argv), model, say)
    return model.state_dict(), report


def _bn_scales(model):
    return {f"{name}.weight" for name, m in model.named_modules() if isinstance(m, BatchNorm)}


def test_download_weights_resolves_a_local_file(tmp_path):
    f = tmp_path / "yolov8_s_backbone_weights.pth"
    f.write_bytes(b"x")
    assert download_weights("s", str(tmp_path)) == jax_download_weights("s", str(tmp_path))
    assert download_weights("s", str(tmp_path)) == str(f)


@pytest.mark.parametrize("phi", ["n", "x", "q"])
def test_download_weights_raises_as_jax(tmp_path, phi):
    """A missing file raises the JAX function's error, word for word: the
    local path and the release URL (none for an unknown phi)."""
    with pytest.raises(FileNotFoundError) as got:
        download_weights(phi, str(tmp_path))
    with pytest.raises(FileNotFoundError) as ref:
        jax_download_weights(phi, str(tmp_path))
    assert str(got.value) == str(ref.value)
    if phi != "q":
        assert f"yolov8_{phi}_backbone_weights.pth" in str(got.value)
        assert "https://github.com/bubbliiiing/yolov8-pytorch" in str(got.value)


def test_flax_default_init_matches_jax_init_model(jax_variables):
    """Biases, BN parameters and statistics and BiFPN `w` exactly JAX's;
    each kernel leaf of at least 4096 elements within 10% of JAX's standard
    deviation and every kernel value within ±2 truncated stddevs."""
    ref = from_jax_variables(jax_variables)
    model = flax_default_init(DCFAYolo(ModelConfig(**CFG)), seed=0)
    sd = model.state_dict()
    assert set(sd) == set(ref)
    big = 0
    for name, t in sd.items():
        r = ref[name]
        assert t.shape == r.shape, name
        if t.dim() != 4:
            assert torch.equal(t, r), name
            continue
        hwio = (t.shape[2], t.shape[3], t.shape[1], t.shape[0])
        std = math.sqrt(1.0 / math.prod(hwio[:-1])) / TRUNC_STD
        assert float(t.abs().max()) <= 2 * std * (1 + 1e-6), name
        assert float(r.abs().max()) <= 2 * std * (1 + 1e-6), name
        if t.numel() >= 4096:
            big += 1
            assert abs(float(t.std()) / float(r.std()) - 1) < 0.10, name
    assert big >= 40
    # a fresh draw from the same seed is the same; another seed is not
    again = flax_default_init(DCFAYolo(ModelConfig(**CFG)), seed=0).state_dict()
    other = flax_default_init(DCFAYolo(ModelConfig(**CFG)), seed=1).state_dict()
    name = "backbone_rgb.stem.conv.weight"
    assert name in sd
    assert torch.equal(again[name], sd[name]) and not torch.equal(other[name], sd[name])


def test_partial_import_matches_jax(jax_variables, backbone):
    """The `--pretrained` import (`train.py:206-214`): a `backbone.*` file
    fills both branches with the same tensors, JAX's after
    `from_jax_variables`; the rest stays at the initial state; the same
    matched and skipped keys."""
    sd = {f"backbone.{k}": v for k, v in backbone.items()}
    template = flax_default_init(DCFAYolo(ModelConfig(**CFG)), seed=0).state_dict()
    got, report = import_state_dict(sd, template, strict=False)
    ref_vars, ref_report = jax_import_state_dict(sd, jax_variables, strict=False)
    ref = from_jax_variables(ref_vars)

    assert report["matched"] == ref_report["matched"]
    assert report["skipped"] == ref_report["skipped"]
    assert len(report["matched"]) > 200
    assert all(k.endswith("num_batches_tracked") for k in report["skipped"])
    rgb = {k[len("backbone_rgb."):]: v for k, v in got.items()
           if k.startswith("backbone_rgb.")}
    assert rgb
    for rest, t in rgb.items():
        assert torch.equal(t, got[f"backbone_nir.{rest}"]), rest
        for branch in ("backbone_rgb", "backbone_nir"):
            assert torch.equal(t, ref[f"{branch}.{rest}"]), (branch, rest)
    for name, t in got.items():
        if not name.startswith("backbone_"):
            assert torch.equal(t, template[name]), name
    assert not torch.equal(got["backbone_rgb.stem.conv.weight"],
                           template["backbone_rgb.stem.conv.weight"])


def test_model_path_loads_over_the_jax_initial_state(dataset, backbone, tmp_path,
                                                     jax_variables):
    """`--model-path` with a single-modal `backbone.*` .npz: the file fills
    both backbones and every tensor it does not fill starts at the JAX
    model's initial state, as `train.py:195-197` loads it: every BN scale
    outside the file exactly 1.0, biases and BN statistics exactly JAX's."""
    npz = tmp_path / "backbone_only.npz"
    np.savez(npz, **{f"backbone.{k}": v for k, v in backbone.items()})
    r = run(_args(dataset, tmp_path / "logs", "--model-path", str(npz),
                  "--unfreeze-epoch", "0", "--no-fold-shuffle"))
    params = r["trainer"].state.params
    model = DCFAYolo(ModelConfig(**CFG))
    outside = [n for n in _bn_scales(model) if not n.startswith("backbone_")]
    assert len(outside) > 20
    for name in outside:
        assert torch.equal(params[name], torch.ones_like(params[name])), name
    ref = from_jax_variables(jax_load_variables(str(npz), jax_variables))
    initial = {**params, **r["trainer"].state.batch_stats}  # no step was taken
    assert r["init"]["source"] == "model_path" and set(initial) == set(ref)
    for name, t in initial.items():
        if name.startswith("backbone_") or t.dim() != 4:
            assert torch.equal(t, ref[name]), name


def test_pretrained_cli_trains_from_the_backbone_file(dataset, backbone, tmp_path,
                                                      monkeypatch):
    """`--pretrained --model-dir D`: one epoch of two steps from
    `D/yolov8_n_backbone_weights.pth`, a finite loss, and the trainer's
    weights as its first step finds them (unfolded): both backbones equal
    to the file and the head at the JAX model's initial state."""
    d = _model_dir(tmp_path, backbone)
    seen = _first_step_weights(monkeypatch)
    r = run(_args(dataset, tmp_path / "logs", "--pretrained", "--model-dir", str(d),
                  "--unfreeze-epoch", "1", "--no-eval"))
    (epoch,) = r["epochs"]
    assert epoch["steps"] == 2 and np.isfinite([epoch["loss"], epoch["val_loss"]]).all()
    assert r["trainer"].model.fold_shuffle and len(seen) == 1
    init, (initial,) = r["init"], seen
    assert init["source"] == "pretrained" and init["path"] == str(
        d / "yolov8_n_backbone_weights.pth")
    n_file = sum(not k.endswith("num_batches_tracked") for k in backbone)
    assert len(init["matched"]) == 2 * n_file
    assert len(init["skipped"]) == 2 * (len(backbone) - n_file)
    for k, v in backbone.items():
        if k.endswith("num_batches_tracked"):
            continue
        want = torch.from_numpy(np.asarray(v, np.float32))
        for branch in ("backbone_rgb", "backbone_nir"):
            name = reference_key_to_port(f"{branch}.{k}")
            assert torch.equal(initial[name], want), (branch, k)
    model = DCFAYolo(ModelConfig(**CFG))
    for name in _bn_scales(model):
        if not name.startswith("backbone_"):
            assert torch.equal(initial[name], torch.ones_like(initial[name])), name
    # the trained weights moved off the initial state
    assert not torch.equal(r["trainer"].state.params["cv2_0_2.weight"],
                           initial["cv2_0_2.weight"])


def test_pretrained_reads_the_file_by_content(backbone, tmp_path):
    """A `.npz` saved under the `.pth` name imports the same as the
    `torch.save` file (`load_torch_checkpoint` reads by content)."""
    d = _model_dir(tmp_path, backbone)
    other = tmp_path / "npz_dir"
    other.mkdir()
    with open(other / "yolov8_n_backbone_weights.pth", "wb") as f:
        np.savez(f, **backbone)
    assert set(load_torch_checkpoint(str(other / "yolov8_n_backbone_weights.pth"))) == set(
        backbone)
    a, ra = _initial(["--pretrained", "--model-dir", str(d)])
    b, rb = _initial(["--pretrained", "--model-dir", str(other)])
    assert ra["matched"] == rb["matched"] and ra["skipped"] == rb["skipped"]
    for name, t in a.items():
        assert torch.equal(t, b[name]), name


def test_missing_backbone_file_raises_before_any_step(dataset, tmp_path):
    """No file in --model-dir: the CLI raises naming the URL, before it
    writes a log or takes a step."""
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="yolov8_n_backbone_weights.pth.*"
                                                "github.com/bubbliiiing"):
        run(_args(dataset, tmp_path / "logs", "--pretrained", "--model-dir",
                  str(tmp_path / "empty"), "--unfreeze-epoch", "1"))
    assert not (tmp_path / "logs").exists()


def test_init_sources_are_exclusive(backbone, tmp_path):
    """One source of four, in `train.py`'s order: --model-path wins over
    --pretrained, and with neither the reference init draws BN scales
    around 1 (not exactly 1)."""
    d = _model_dir(tmp_path, backbone)
    npz = tmp_path / "w.npz"
    np.savez(npz, **{f"backbone.{k}": v for k, v in backbone.items()})
    _, rep = _initial(["--model-path", str(npz), "--pretrained", "--model-dir", str(d)])
    assert rep["source"] == "model_path"
    sd, rep = _initial([])
    assert rep["source"] == "init"
    scale = sd["cv2_0_0.bn.weight"]
    assert not torch.equal(scale, torch.ones_like(scale))
    assert float((scale - 1).abs().max()) < 0.2
