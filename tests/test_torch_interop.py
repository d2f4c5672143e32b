"""Weights in and out of the port, on the CPU: the reference's `.pth` / `.npz`
(`models/torch_import.py`), the JAX package's msgpack `.ckpt`
(`utils/checkpoint.py`), the export to the reference's key space
(`models/torch_export.py`), every entry point that takes a model path, and
the `torch.export` artifact of the deploy pipeline (`tools/export.py`).

The port is held against the reference itself (`tests/goldens/model_fwd.npz`,
at tests/test_model_parity.py's limits) in a process without JAX, and
against the JAX importer, exporter and loader bit for bit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from dcfa_yolo_tpu.config import ModelConfig as JaxModelConfig
from dcfa_yolo_tpu.models.torch_export import export_state_dict as jax_export_state_dict
from dcfa_yolo_tpu.models.torch_import import import_state_dict as jax_import_state_dict
from dcfa_yolo_tpu.models.yolo import DCFAYolo as JaxDCFAYolo
from dcfa_yolo_tpu.utils import golden as jax_golden
from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.models.convert import from_jax_variables, load_flat_npz
from dcfa_yolo_tpu_torch.models.torch_export import export_state_dict, save_torch_npz
from dcfa_yolo_tpu_torch.models.torch_import import (import_state_dict,
                                                     load_torch_checkpoint)
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo, init_model
from dcfa_yolo_tpu_torch.utils import golden
from dcfa_yolo_tpu_torch.utils.checkpoint import (FORMATS, decode_msgpack,
                                                  load_variables, read_weights,
                                                  save_checkpoint)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
MANIFEST = REPO / "tests" / "goldens" / "manifest.json"
FIXTURE = REPO / "tests" / "fixtures" / "ab_weights_f16.npz"


def _template(num_classes=1):
    """The port's train-graph state_dict: the importer's template."""
    return DCFAYolo(ModelConfig(num_classes=num_classes, phi="n")).state_dict()


def _jax_template():
    """The flax variables' shapes, as eval_shape gives them (parameter
    shapes do not depend on the input size)."""
    model = JaxDCFAYolo(JaxModelConfig(num_classes=1, phi="n"))
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    return jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), dummy, dummy, train=False))


@pytest.fixture(scope="module")
def synth():
    return golden.synth_state_dict(golden.load_manifest(str(MANIFEST)), seed=0)


@pytest.fixture(scope="module")
def jax_variables(synth):
    variables, _ = jax_import_state_dict(synth, _jax_template(), strict=True)
    return variables


def _assert_same_state(a, b):
    assert a.keys() == b.keys()
    bad = [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]
    assert not bad, bad[:5]


# --- (a) the port alone against the reference's outputs ----------------------

_ALONE = """
import json, sys, tempfile, os
import numpy as np, torch
torch.set_num_threads(1)
from dcfa_yolo_tpu_torch.config import ModelConfig
from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
from dcfa_yolo_tpu_torch.models.torch_import import import_state_dict
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo
from dcfa_yolo_tpu_torch.utils import golden
sd = golden.synth_state_dict(golden.load_manifest("tests/goldens/manifest.json"), 0)
_, report = import_state_dict(sd, DCFAYolo(ModelConfig(phi="n")).state_dict(),
                              strict=True)
path = os.path.join(tempfile.mkdtemp(), "reference.pth")
torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
pred = YOLOPredictor(["object"], input_shape=(640, 640), model_path=path,
                     compute_dtype="float32", device="cpu")
with np.load("tests/goldens/model_fwd.npz") as z:
    errors = golden.golden_errors(pred.model, {k: z[k] for k in z.files})
jax = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "dcfa_yolo_tpu"))
print(json.dumps(dict(errors=errors, skipped=report["skipped"],
                      missing=report["missing"], jax=jax)))
"""


@pytest.fixture(scope="module")
def alone():
    """A reference `.pth` of the manifest's synthetic weights served by the
    port's `YOLOPredictor` on the CPU in float32, in a process that imports
    no JAX; its forward against the goldens and the import report."""
    proc = subprocess.run([sys.executable, "-c", _ALONE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_reference_pth_meets_goldens_without_jax(alone):
    """The seven taps, the three head maps, dbox and cls within
    tests/test_model_parity.py's limits (`golden.GOLDEN_TOL`)."""
    assert alone["jax"] == []
    assert len(alone["errors"]) == 12
    over = {k: v for k, v in alone["errors"].items() if not v <= 1.0}
    assert not over, over


def test_reference_import_report(alone):
    """Nothing missing; only `num_batches_tracked` and the frozen DFL conv
    skipped."""
    assert alone["missing"] == []
    assert alone["skipped"] and all(k.endswith("num_batches_tracked") or k.startswith("dfl.")
                                    for k in alone["skipped"])
    assert len(alone["skipped"]) == 85


def test_golden_helpers_equal_the_jax_package():
    """The port's copy of `utils/golden.py` makes the JAX package's values
    bit for bit, over the whole manifest."""
    manifest = golden.load_manifest(str(MANIFEST))
    assert manifest == jax_golden.load_manifest(str(MANIFEST))
    mine, ref = golden.synth_state_dict(manifest, 3), jax_golden.synth_state_dict(manifest, 3)
    assert mine.keys() == ref.keys()
    assert all(mine[k].dtype == ref[k].dtype and np.array_equal(mine[k], ref[k]) for k in mine)
    for name in ("rgb", "nir"):
        np.testing.assert_array_equal(golden.synth_input(name, (2, 3, 8, 8), 1),
                                      jax_golden.synth_input(name, (2, 3, 8, 8), 1))


# --- (b) importer, (c) exporter: bit for bit against the JAX package ----------

def test_importer_equals_jax_import_then_carrier(synth, jax_variables):
    mine, report = import_state_dict(synth, _template(), strict=True)
    _assert_same_state(mine, from_jax_variables(jax_variables))
    _, jax_report = jax_import_state_dict(synth, _jax_template(), strict=True)
    assert report["matched"] == jax_report["matched"]
    assert report["skipped"] == jax_report["skipped"]


def test_single_modal_backbone_file_fills_both_backbones(synth):
    """A single-modal `backbone.*` file (`train_mul.py:150-159`) fills both
    backbones and leaves the rest as in the template, as the JAX importer
    does; without the surgery nothing loads."""
    single = {"backbone." + k[len("backbone_rgb."):]: v for k, v in synth.items()
              if k.startswith("backbone_rgb.")}
    filler = jax.tree_util.tree_map(lambda s: np.full(s.shape, 0.5, np.float32),
                                    _jax_template())
    jax_vars, jax_report = jax_import_state_dict(single, filler)
    mine, report = import_state_dict(single, from_jax_variables(filler))
    _assert_same_state(mine, from_jax_variables(jax_vars))
    assert report["matched"] == jax_report["matched"]
    assert len(report["missing"]) == len(jax_report["missing"]) > 0
    assert all(not k.startswith("backbone_") for k in report["missing"])
    assert torch.equal(mine["backbone_rgb.stem.conv.weight"],
                       mine["backbone_nir.stem.conv.weight"])
    _, none = import_state_dict(single, _template(), duplicate_single_backbone=False)
    assert none["matched"] == [] and len(none["skipped"]) == len(single)


def test_importer_refuses_a_shape_mismatch_and_a_partial_strict_load(synth):
    bad = dict(synth)
    bad["cv3.0.2.weight"] = np.zeros((2, 64, 1, 1), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        import_state_dict(bad, _template())
    partial = {k: v for k, v in synth.items() if not k.startswith("cv3.")}
    with pytest.raises(ValueError, match="not filled"):
        import_state_dict(partial, _template(), strict=True)


def test_exporter_equals_jax_exporter(jax_variables):
    mine = export_state_dict(from_jax_variables(jax_variables), num_classes=1)
    ref = jax_export_state_dict(jax_variables, num_classes=1)
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k].dtype == ref[k].dtype and np.array_equal(mine[k], ref[k]), k


def test_export_key_space_is_the_manifest_and_import_inverts_it(tmp_path):
    """The exported keys and shapes are the manifest's; importing the export
    gives back the state_dict (here `init_model`'s, phi='n', 1 class)."""
    sd = init_model(ModelConfig(num_classes=1, phi="n", input_shape=(64, 64)), 5,
                    "cpu").state_dict()
    out = export_state_dict(sd, num_classes=1)
    manifest = golden.load_manifest(str(MANIFEST))
    assert {k: list(v.shape) for k, v in out.items()} == manifest
    np.testing.assert_array_equal(out["dfl.conv.weight"].ravel(), np.arange(16))
    back, report = import_state_dict(out, _template(), strict=True)
    _assert_same_state(back, sd)
    save_torch_npz(str(tmp_path / "w.npz"), sd)
    loaded = load_torch_checkpoint(str(tmp_path / "w.npz"))
    assert loaded.keys() == out.keys()
    assert all(np.array_equal(loaded[k], out[k]) for k in out)
    with pytest.raises(ValueError, match="caller claimed 3"):
        export_state_dict(sd, num_classes=3)
    deploy = init_model(ModelConfig(num_classes=1, phi="n", input_shape=(64, 64)), 5,
                        "cpu", deploy=True).state_dict()
    with pytest.raises(KeyError, match="cheap_bn"):  # as the JAX exporter
        export_state_dict(deploy)


# --- (d) the JAX package's msgpack checkpoint ---------------------------------

@pytest.mark.parametrize("with_ema", [True, False])
def test_jax_checkpoint_loads_as_the_jax_loader_picks(tmp_path, jax_variables, with_ema):
    """A JAX `save_checkpoint` payload (params, batch_stats, optax state,
    EMA or none, epoch) through the port's `load_variables` equals
    `from_jax_variables` of what the JAX `load_variables` picks; the
    port's decoder gives flax's `msgpack_restore` tree."""
    import optax
    from flax import serialization

    from dcfa_yolo_tpu.utils.checkpoint import load_variables as jax_load_variables
    from dcfa_yolo_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint

    params, stats = jax_variables["params"], jax_variables["batch_stats"]
    half = jax.tree_util.tree_map(lambda x: np.asarray(x) * 0.5, dict(jax_variables))
    payload = dict(params=params, batch_stats=stats,
                   opt_state=optax.sgd(0.01, momentum=0.9, nesterov=True).init(params),
                   ema=half if with_ema else {}, ema_updates=7, epoch=3)
    path = tmp_path / "jax.ckpt"
    jax_save_checkpoint(str(path), payload)
    want = from_jax_variables(jax_load_variables(str(path)))
    _assert_same_state(load_variables(str(path)), want)
    if with_ema:
        assert torch.equal(want["cv2_0_2.bias"], from_jax_variables(half)["cv2_0_2.bias"])

    blob = path.read_bytes()
    mine, ref = decode_msgpack(blob), serialization.msgpack_restore(blob)

    def same(a, b):
        if isinstance(b, dict):
            return isinstance(a, dict) and a.keys() == b.keys() and all(
                same(a[k], b[k]) for k in b)
        if isinstance(b, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b)
        return a == b and type(a) is type(b)

    assert same(mine, ref)


def test_msgpack_decoder_leaves():
    """Arrays of every shape and dtype the JAX checkpoints hold, 0-d ones
    included, and lists as flax's `to_state_dict` form; truncated bytes
    raise."""
    import msgpack
    from flax import serialization

    tree = {"f": np.arange(6, dtype=np.float32).reshape(2, 3), "n": np.asarray(7, np.int32),
            "l": [1, 2.0, "x"], "d": {"i": np.arange(4, dtype=np.int64)}}
    blob = serialization.msgpack_serialize(tree)
    mine = decode_msgpack(blob)
    for k in ("f", "n"):
        assert mine[k].dtype == tree[k].dtype and np.array_equal(mine[k], tree[k])
        assert mine[k].flags.writeable
    np.testing.assert_array_equal(mine["d"]["i"], tree["d"]["i"])
    assert mine["l"] == {"0": 1, "1": 2.0, "2": "x"}
    assert msgpack.unpackb(blob)["l"] == [1, 2.0, "x"]
    with pytest.raises(ValueError):
        decode_msgpack(blob[:-3])


# --- (e) the format is told by content, whatever the file is called ----------

def _port_checkpoint(path, sd):
    save_checkpoint(str(path), dict(params=sd, batch_stats={}, ema={}, opt_state={},
                                    ema_updates=0, epoch=0))


@pytest.mark.parametrize("kind,name", [("port", "w.pth"), ("port", "w.npz"),
                                       ("reference_pth", "w.ckpt"),
                                       ("reference_npz", "w.pth"), ("jax", "w.pth"),
                                       ("jax", "w.npz"), ("reference_legacy", "w.pth")])
def test_format_is_told_by_content(tmp_path, jax_variables, kind, name):
    from dcfa_yolo_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint

    sd = from_jax_variables(jax_variables)
    path = tmp_path / name
    if kind == "port":
        _port_checkpoint(path, sd)
    elif kind in ("reference_pth", "reference_legacy"):
        # the legacy case: torch's pre-zip format, a pickle stream, not a zip
        torch.save({k: torch.from_numpy(v) for k, v in export_state_dict(sd).items()},
                   str(path), _use_new_zipfile_serialization=kind == "reference_pth")
    elif kind == "reference_npz":
        with open(path, "wb") as f:
            np.savez(f, **export_state_dict(sd))
    else:
        jax_save_checkpoint(str(path), dict(params=jax_variables["params"],
                                            batch_stats=jax_variables["batch_stats"]))
    assert read_weights(str(path))[0] == kind.split("_")[0]
    _assert_same_state(load_variables(str(path), _template), sd)


def test_unknown_files_raise_naming_the_four_formats(tmp_path):
    import zipfile

    (tmp_path / "t.ckpt").write_text("not weights\n")
    with zipfile.ZipFile(tmp_path / "z.pth", "w") as z:
        z.writestr("a.txt", "hi")
    torch.save({"lr": 0.1, "names": ["a"]}, tmp_path / "cfg.pth")
    (tmp_path / "trunc.ckpt").write_bytes(b"\x86\xa6params\x80")
    (tmp_path / "list.ckpt").write_bytes(b"\x92\x01\x02")
    for name in ("t.ckpt", "z.pth", "cfg.pth", "trunc.ckpt", "list.ckpt"):
        with pytest.raises(ValueError) as e:
            load_variables(str(tmp_path / name), _template)
        assert str(tmp_path / name) in str(e.value)
        assert all(f in str(e.value) for f in FORMATS), name


def test_pickled_objects_and_foreign_keys_raise(tmp_path):
    """A `.pth` that only loads by running pickle code raises, naming the
    file, and so does a reference-shaped file none of whose keys the model
    has; a reference file needs the template."""
    import argparse

    torch.save({"args": argparse.Namespace(lr=0.1),
                "state_dict": {"bi_fpn.w": torch.ones(3)}}, tmp_path / "p.pth")
    with pytest.raises(ValueError, match=r"p\.pth.*pickle code"):
        load_variables(str(tmp_path / "p.pth"), _template)
    np.savez(tmp_path / "w.npz", a=np.zeros(3))
    with pytest.raises(ValueError, match="none of its 1 keys"):
        load_variables(str(tmp_path / "w.npz"), _template)
    torch.save({"state_dict": {"bi_fpn.w": torch.ones(3)}}, tmp_path / "s.pth")
    with pytest.raises(ValueError, match="template"):
        load_variables(str(tmp_path / "s.pth"))
    sd = load_variables(str(tmp_path / "s.pth"), _template)
    assert torch.equal(sd["bi_fpn.w"], torch.ones(3))


# --- (f) YOLOPredictor on trained weights, against the JAX facade -----------

@pytest.fixture(scope="module")
def trained_files(tmp_path_factory):
    """The trained fixture as the reference's `.npz` and `.pth` and as a
    JAX `.ckpt` (what a JAX training run writes: no EMA)."""
    from dcfa_yolo_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint

    d = tmp_path_factory.mktemp("trained")
    tree = load_flat_npz(str(FIXTURE))
    sd = from_jax_variables(tree)
    save_torch_npz(str(d / "trained.npz"), sd)
    torch.save({k: torch.from_numpy(v) for k, v in export_state_dict(sd).items()},
               str(d / "trained.pth"))
    jax_save_checkpoint(str(d / "trained.ckpt"), dict(
        params=tree["params"], batch_stats=tree["batch_stats"], ema={}, epoch=0))
    return sd, {ext: str(d / f"trained.{ext}") for ext in ("npz", "pth", "ckpt")}


def test_trained_files_load_the_fixture_exactly(trained_files):
    sd, files = trained_files
    for path in files.values():
        _assert_same_state(load_variables(path, _template), sd)


def test_predictor_on_trained_files_matches_jax_at_640(trained_files, tmp_path):
    """`YOLOPredictor(model_path=...)` of the port and of the JAX package on
    each file, float32 640², 2 synthetic 480×360 pairs, conf 0.5, IoU 0.5:
    the same counts, classes equal, boxes within 1 px, scores within 1e-3
    (tests/test_torch_serving.py's trained-weights limits)."""
    from dcfa_yolo_tpu.infer.predictor import YOLOPredictor as JaxPredictor
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
    from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset

    make_dataset(str(tmp_path), 2, (480, 360))
    voc = tmp_path / "VOCdevkit" / "VOC2007"
    pairs = [(Image.open(voc / "JPEGImages_rgb" / f"{i:06d}.png"),
              Image.open(voc / "JPEGImages_nir" / f"{i:06d}.png")) for i in range(2)]
    kw = dict(class_names=["tomato_bunch"], input_shape=(640, 640), phi="n",
              confidence=0.5, nms_iou=0.5, max_det=100, pre_nms_topk=2048,
              compute_dtype="float32")
    total = 0
    for ext, path in trained_files[1].items():
        port = YOLOPredictor(model_path=path, device="cpu", **kw)
        ref = JaxPredictor(model_path=path, **kw)
        for rgb, nir in pairs:
            (b0, s0, c0), (b1, s1, c1) = port.detect(rgb, nir), ref.detect(rgb, nir)
            assert len(b0) == len(b1), ext
            total += len(b0)
            np.testing.assert_array_equal(c0, np.asarray(c1))
            assert np.abs(b0 - np.asarray(b1)).max(initial=0) <= 1.0, ext
            assert np.abs(s0 - np.asarray(s1)).max(initial=0) < 1e-3, ext
    assert total > 0, "degenerate: the trained fixture detected nothing"


# --- (g) the CLIs with a reference .pth ---------------------------------------

@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """6 synthetic 160×120 pairs (3 in test, 2 train, 1 val), `init_model`
    weights at 64² as a port checkpoint and as a reference `.pth`."""
    from dcfa_yolo_tpu_torch.data import voc
    from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset

    d = tmp_path_factory.mktemp("cli")
    make_dataset(str(d), 6, (160, 120))
    devkit = str(d / "VOCdevkit")
    voc.generate_imagesets(devkit, trainval_percent=0.5, train_percent=0.67)
    voc.generate_annotation_files(devkit, str(d / "model_data" / "voc_classes.txt"),
                                  out_dir=str(d), image_ext=".png")
    sd = init_model(ModelConfig(num_classes=1, phi="n", input_shape=(64, 64)), 0,
                    "cpu").state_dict()
    _port_checkpoint(d / "w.ckpt", sd)
    torch.save({k: torch.from_numpy(v) for k, v in export_state_dict(sd).items()},
               str(d / "w.pth"))
    return d


def _serve_args(d, weights):
    return ["--device", "cpu", "--input-shape", "64", "64", "--model-path",
            str(d / weights), "--classes-path", str(d / "model_data" / "voc_classes.txt")]


def test_predict_and_get_map_take_a_reference_pth(cli_data, tmp_path):
    """`predict --mode predict` draws the same image and `get_map
    --map-mode 1` writes the same detection files from the `.pth` as from
    the port checkpoint of the same weights."""
    from dcfa_yolo_tpu_torch import get_map, predict

    img = cli_data / "VOCdevkit" / "VOC2007"
    pair = ["--rgb", str(img / "JPEGImages_rgb" / "000000.png"),
            "--nir", str(img / "JPEGImages_nir" / "000000.png")]
    for w in ("w.pth", "w.ckpt"):
        predict.run(["--mode", "predict", "--confidence", "0.01", "--output",
                     str(tmp_path / f"{w}.png")] + pair + _serve_args(cli_data, w))
        get_map.run(["--map-mode", "1", "--confidence", "0.01", "--vocdevkit-path",
                     str(cli_data / "VOCdevkit"), "--map-out-path", str(tmp_path / w)]
                    + _serve_args(cli_data, w))
    a, b = (np.asarray(Image.open(tmp_path / f"{w}.png")) for w in ("w.pth", "w.ckpt"))
    assert np.array_equal(a, b)
    files = sorted((tmp_path / "w.ckpt" / "detection-results").iterdir())
    assert len(files) == 3 and any(f.read_text().strip() for f in files)
    for f in files:
        assert (tmp_path / "w.pth" / "detection-results" / f.name).read_text() == f.read_text()


def test_train_cli_loads_a_single_modal_pth_into_both_backbones(cli_data, tmp_path):
    """A `backbone.*` `.pth` loads over the init into both backbones; one
    frozen epoch keeps their parameters, so the last checkpoint holds the
    file's values in both, while the head trained from its init."""
    from dcfa_yolo_tpu_torch.train.__main__ import run
    from dcfa_yolo_tpu_torch.utils.checkpoint import load_checkpoint

    ref = export_state_dict(init_model(ModelConfig(num_classes=1, phi="n",
                                                   input_shape=(64, 64)), 9,
                                       "cpu").state_dict())
    single = {"backbone." + k[len("backbone_rgb."):]: torch.from_numpy(v)
              for k, v in ref.items() if k.startswith("backbone_rgb.")}
    torch.save(single, str(tmp_path / "backbone.pth"))
    out = run(["--classes-path", str(cli_data / "model_data" / "voc_classes.txt"),
               "--train-annotation", str(cli_data / "2007_train.txt"),
               "--val-annotation", str(cli_data / "2007_val.txt"),
               "--input-shape", "64", "64", "--batch-size", "2",
               "--compute-dtype", "float32", "--num-workers", "1", "--device", "cpu",
               "--freeze-train", "--freeze-epoch", "1", "--unfreeze-epoch", "1",
               "--eval-period", "5", "--model-path", str(tmp_path / "backbone.pth"),
               "--save-dir", str(tmp_path / "logs")])
    last = load_checkpoint(str(Path(out["log_dir"]) / "last_epoch_weights.ckpt"))
    params = last["params"]
    want, _ = import_state_dict({k: v.numpy() for k, v in single.items()}, _template())
    for branch in ("backbone_rgb.", "backbone_nir."):
        keys = [k for k in params if k.startswith(branch)]
        assert keys and all(torch.equal(params[k], want[k]) for k in keys), branch
    from dcfa_yolo_tpu_torch.train.init_weights import reference_weights_init

    m = DCFAYolo(ModelConfig(num_classes=1, phi="n", input_shape=(64, 64)))
    reference_weights_init(m, seed=0)
    assert not torch.equal(params["cv3_0_2.weight"], m.state_dict()["cv3_0_2.weight"])


# --- (h) the torch.export artifact --------------------------------------------

_ONLY_TORCH = """
import json, sys, torch
torch.set_num_threads(1)
program = torch.export.load("pipeline.pt2")
inputs = torch.load("inputs.pt")
got = program.module()(*inputs)
want = torch.load("want.pt")
bad = [k for k in want if not torch.equal(got[k], want[k])]
ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
foreign = sorted(o for o in ops if not (o.startswith("aten.") or o == "<built-in function getitem>"))
mods = sorted(m for m in sys.modules if m.split(".")[0] in ("dcfa_yolo_tpu_torch", "dcfa_yolo_tpu", "jax"))
print(json.dumps([sorted(got), bad, foreign, mods]))
"""


def test_export_tool_artifact_runs_with_only_torch(tmp_path):
    """`python -m dcfa_yolo_tpu_torch.tools.export` at 64², b2, on the CPU:
    the tool's own round trip passes (the artifact as loaded equals the
    in-process plain pipeline), and in a process that imports only torch
    the artifact gives the same outputs, with aten ops only."""
    from dcfa_yolo_tpu_torch.tools.export import run

    out = run([str(tmp_path / "pipeline.pt2"), "--batch", "2", "--size", "64",
               "--conf", "0.01", "--nms-iou", "0.5", "--device", "cpu",
               "--classes-path", str(tmp_path / "none.txt")])
    assert out["bytes"] == (tmp_path / "pipeline.pt2").stat().st_size > 1_000_000
    with torch.inference_mode():
        want = out["pipeline"](*out["check_inputs"])
    assert want["valid"].any()
    torch.save(tuple(out["check_inputs"]), tmp_path / "inputs.pt")
    torch.save(want, tmp_path / "want.pt")
    proc = subprocess.run([sys.executable, "-c", _ONLY_TORCH], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    fields, bad, foreign, mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert fields == sorted(["boxes", "scores", "classes", "valid", "n_candidates"])
    assert bad == [] and foreign == [] and mods == []


def test_export_nms_relation_equals_the_loop(monkeypatch):
    """Under torch.export the plain NMS makes all K keep updates over its
    IoU relation (no host read of the last alive candidate): the same keep
    mask as the eager call and as the JAX package's XLA greedy NMS, on
    overlapping boxes with duplicates and dead candidates, over more rows
    than one relation chunk."""
    from dcfa_yolo_tpu.ops.boxes import pairwise_iou_xyxy
    from dcfa_yolo_tpu.ops.nms import _greedy_suppress
    from dcfa_yolo_tpu_torch.ops import cuda_nms
    from dcfa_yolo_tpu_torch.ops.cuda_nms import greedy_suppress_plain

    monkeypatch.setattr(cuda_nms, "_ROWS_PER_STEP", 40)  # three chunks of 96 rows

    class Suppress(torch.nn.Module):
        def forward(self, boxes, alive):
            return greedy_suppress_plain(boxes, alive, 0.5)

    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 50, (2, 96, 2)).astype(np.float32)
    wh = rng.uniform(5, 20, (2, 96, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1))
    boxes[:, 1::9] = boxes[:, 0::9][:, :boxes[:, 1::9].shape[1]]  # duplicates: IoU 1
    alive = torch.from_numpy(rng.random((2, 96)) > 0.1)
    alive[:, 90:] = False  # eager stops at the last alive row, export runs all 96
    program = torch.export.export(Suppress(), (boxes, alive), strict=False)
    got = program.module()(boxes, alive)
    assert torch.equal(got, greedy_suppress_plain(boxes, alive, 0.5))
    want = jax.vmap(lambda bx, al: _greedy_suppress(pairwise_iou_xyxy(bx, bx), al, 0.5)
                    & al)(jnp.asarray(boxes.numpy()), jnp.asarray(alive.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_constant_cache_keeps_nothing_made_during_an_export():
    """A device constant first made while `torch.export` traces is used by
    the trace but not kept, so that no later eager or graph call reads a
    traced tensor; the next eager call makes and keeps its own."""
    from dcfa_yolo_tpu_torch.ops import consts

    key = ("interop-test", 3)

    class AddConst(torch.nn.Module):
        def forward(self, x):
            return x + consts.device_const(key, lambda: [1.0, 2.0, 3.0],
                                           torch.float32, x.device)

    x = torch.zeros(3)
    program = torch.export.export(AddConst(), (x,), strict=False)
    assert not [k for k in consts._CACHE if k[0] == key]
    assert torch.equal(program.module()(x), torch.tensor([1.0, 2.0, 3.0]))
    assert torch.equal(AddConst()(x), torch.tensor([1.0, 2.0, 3.0]))
    made = consts._CACHE.pop((key, torch.float32, torch.device("cpu")))
    assert not isinstance(made, torch._subclasses.FakeTensor)
