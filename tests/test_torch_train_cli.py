"""The port's training CLI (`python -m dcfa_yolo_tpu_torch.train`) on the CPU,
at 64² float32 on a 6-pair synthetic dataset (4 train, 2 val), and the
pieces it adds: exact resume, folded training, `fold_opt_state`, and the
mAP protocol's detection files against the JAX predictor's.

Tolerances: resume on the CPU is bit-identical (the same data, generators,
weights, optimizer and EMA state in the same order).  Folded against
unfolded training follows tests/test_fold_shuffle_train.py: loss rtol 1e-3
per step, and the updates of every state entry agree after unfolding up to
rare summation-order elements (at most 1% beyond a quarter of the leaf's
largest update).  The map txt lines must be equal.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
from dcfa_yolo_tpu_torch.data import voc
from dcfa_yolo_tpu_torch.models.reparam import (apply_shuffle_spec, fold_opt_state,
                                                fold_shuffle_state_dict,
                                                shuffle_fold_spec)
from dcfa_yolo_tpu_torch.models.yolo import DCFAYolo, init_model
from dcfa_yolo_tpu_torch.profile_train import synthetic_batch
from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset
from dcfa_yolo_tpu_torch.train.__main__ import run
from dcfa_yolo_tpu_torch.train.trainer import Trainer
from dcfa_yolo_tpu_torch.utils.checkpoint import (load_checkpoint, load_variables,
                                                  save_checkpoint)
from dcfa_yolo_tpu_torch.utils.profiling import StepTimer

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


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
            "--save-period", "1", "--eval-period", "2", "--num-workers", "2",
            "--save-dir", str(save_dir), "--device", "cpu", *extra]


def _lines(path):
    return [l for l in Path(path).read_text().splitlines() if l.strip()]


def test_cli_trains_saves_and_resumes(dataset, tmp_path):
    r1 = run(_args(dataset, tmp_path / "logs", "--unfreeze-epoch", "2",
                   "--train-stem", "pallas"))
    log1 = Path(r1["log_dir"])
    assert r1["trainer"].train_stem == "kernel"
    assert [e["epoch"] for e in r1["epochs"]] == [1, 2]
    assert all(e["steps"] == 2 and np.isfinite(e["loss"]) and np.isfinite(e["val_loss"])
               for e in r1["epochs"])
    assert r1["epochs"][0]["map"] is None and r1["epochs"][1]["map"] is not None
    assert len(_lines(log1 / "epoch_loss.txt")) == 2
    assert len(_lines(log1 / "epoch_val_loss.txt")) == 2
    maps = _lines(log1 / "epoch_map.txt")
    assert maps[0] == "0" and len(maps) == 2
    names = os.listdir(log1)
    for prefix in ("ep001-loss", "ep002-loss", "best_epoch_weights.ckpt",
                   "last_epoch_weights.ckpt"):
        assert any(n.startswith(prefix) for n in names), names
    assert not (log1 / ".temp_map_out").exists()

    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
    last = load_checkpoint(str(log1 / "last_epoch_weights.ckpt"))
    assert last["epoch"] == 2 and last["ema_updates"] == 4
    r2 = run(_args(dataset, tmp_path / "logs", "--unfreeze-epoch", "3",
                   "--resume", str(log1 / "last_epoch_weights.ckpt")))
    assert r2["init_epoch"] == 2 and r2["ema_updates_at_start"] == 4
    assert [e["epoch"] for e in r2["epochs"]] == [3]
    assert r2["trainer"].ema.updates == 6
    assert load_checkpoint(str(Path(r2["log_dir"]) / "last_epoch_weights.ckpt"))["epoch"] == 3


def test_resume_is_bit_identical_to_the_uninterrupted_run(dataset, tmp_path):
    """Three epochs straight, against two epochs' checkpoint resumed for the
    third: the same losses and the same final state, bit for bit."""
    straight = run(_args(dataset, tmp_path / "a", "--unfreeze-epoch", "3", "--no-eval"))
    log = Path(straight["log_dir"])
    ep2 = next(log.glob("ep002-*.ckpt"))
    resumed = run(_args(dataset, tmp_path / "b", "--unfreeze-epoch", "3", "--no-eval",
                        "--resume", str(ep2)))
    assert resumed["epochs"][0]["loss"] == straight["epochs"][2]["loss"]
    assert resumed["epochs"][0]["val_loss"] == straight["epochs"][2]["val_loss"]
    a = load_checkpoint(str(log / "last_epoch_weights.ckpt"))
    b = load_checkpoint(str(Path(resumed["log_dir"]) / "last_epoch_weights.ckpt"))
    for key in ("params", "batch_stats", "ema"):
        for name, t in a[key].items():
            assert torch.equal(t, b[key][name]), (key, name)
    for name, t in a["opt_state"]["trace"].items():
        assert torch.equal(t, b["opt_state"]["trace"][name]), name
    assert (a["epoch"], a["ema_updates"]) == (b["epoch"], b["ema_updates"]) == (3, 6)


@pytest.mark.parametrize("dtype,tf32", [("float32", False), ("bfloat16", True)])
def test_cli_sets_its_precision(dataset, tmp_path, dtype, tf32):
    """The CLI decides TF32 from --compute-dtype, whatever the process had:
    off for float32 (IEEE float32 convolutions and matmuls), on for
    bfloat16.  No epoch runs at --unfreeze-epoch 0."""
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = not tf32
        r = run(_args(dataset, tmp_path, "--unfreeze-epoch", "0", "--compute-dtype", dtype))
        assert r["epochs"] == []
        assert torch.backends.cudnn.allow_tf32 is tf32
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def test_step_timer_on_the_cpu():
    """On the CPU a sample is the host clock between start and stop; a
    stop without a start adds nothing."""
    timer = StepTimer("cpu")
    assert timer.summary() == {}
    for _ in range(3):
        timer.start()
        torch.ones(64, 64) @ torch.ones(64, 64)
        timer.stop()
    timer.stop()
    s = timer.summary()
    assert s["steps"] == 3 and 0 < s["p50_ms"] <= s["p95_ms"] and s["mean_ms"] > 0


def test_checkpoint_loader_refuses_foreign_files(tmp_path):
    """`load_checkpoint` (what --resume reads) takes only the port's own
    checkpoints and names the formats `load_variables` takes as weights; a
    reference `.pth` whose tensor does not fit the model raises."""
    msgpack = tmp_path / "jax.ckpt"
    msgpack.write_bytes(b"\x86\xa6params\x80")
    with pytest.raises(ValueError, match="only format that resumes.*msgpack .ckpt"):
        load_checkpoint(str(msgpack))
    pth = tmp_path / "ref.pth"
    torch.save({"backbone.stem.conv.0.weight": torch.zeros(2)}, pth)
    with pytest.raises(ValueError, match="only format that resumes.*torch.save .pth"):
        load_checkpoint(str(pth))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_variables(str(pth), DCFAYolo(ModelConfig(num_classes=1, phi="n")).state_dict)
    with pytest.raises(KeyError):
        save_checkpoint(str(tmp_path / "x.ckpt"), {"params": {}})


def _assert_updates_match(a, b, init, frac=0.01):
    """tests/test_fold_shuffle_train.py::assert_updates_match on dicts of
    tensors: per leaf at most `frac` of the elements (2 at least) differ by
    more than a quarter of the leaf's largest update (floor 1e-5)."""
    for name in a:
        x, y, i0 = a[name].numpy(), b[name].numpy(), init[name].numpy()
        d = np.abs(x - y)
        thr = max(1e-5, 0.25 * float(np.abs(x - i0).max()))
        assert int((d > thr).sum()) <= max(2, int(frac * d.size)), (name, d.max(), thr)


def test_folded_training_matches_unfolded():
    """Two SGD steps of the folded graph, unfolded, against two of the
    standard graph from the same weights (tests/test_fold_shuffle_train.py:113)."""
    cfg = ModelConfig(num_classes=1, phi="n", input_shape=(64, 64))
    tc = TrainConfig(max_boxes=4)
    base_model = init_model(cfg, 3, "cpu", train=True)
    sd0 = {k: v.clone() for k, v in base_model.state_dict().items()}
    spec = shuffle_fold_spec(sd0)
    fmodel = DCFAYolo(cfg, fold_shuffle=True)
    fmodel.load_state_dict(fold_shuffle_state_dict(sd0))
    tr_b = Trainer(base_model, tc, device="cpu")
    tr_f = Trainer(fmodel.train(), tc, device="cpu")
    host = synthetic_batch(2, (64, 64), 4, 7)
    for _ in range(2):
        lb = tr_b.train_step(tr_b.put_batch(*host), 1e-3)
        lf = tr_f.train_step(tr_f.put_batch(*host), 1e-3)
        np.testing.assert_allclose(float(lb.total), float(lf.total), rtol=1e-3)
    sb, sf = tr_b.state, tr_f.state
    init_p = {k: sd0[k] for k in sb.params}
    init_s = {k: sd0[k] for k in sb.batch_stats}
    _assert_updates_match(sb.params, apply_shuffle_spec(sf.params, spec, inverse=True), init_p)
    _assert_updates_match(sb.batch_stats, sf.batch_stats, init_s)
    _assert_updates_match(sb.ema, apply_shuffle_spec(sf.ema, spec, inverse=True), sd0)
    zeros = {k: torch.zeros_like(v) for k, v in sb.opt_state["trace"].items()}
    _assert_updates_match(sb.opt_state["trace"],
                          fold_opt_state(sf.opt_state, spec, inverse=True)["trace"], zeros)


@pytest.mark.parametrize("train_bifpn", [True, False])
def test_frozen_bifpn_leaves_the_fusion_weights(train_bifpn):
    """`--frozen-bifpn` (Trainer(train_bifpn=False)) zeroes the BiFPN
    weights' update, as the reference never optimizes them; every other
    parameter still moves, and the momentum trace still accumulates."""
    cfg = ModelConfig(num_classes=1, phi="n", input_shape=(64, 64))
    tr = Trainer(init_model(cfg, 4, "cpu", train=True), TrainConfig(max_boxes=4),
                 device="cpu", train_bifpn=train_bifpn)
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    tr.train_step(tr.put_batch(*synthetic_batch(2, (64, 64), 4, 9)), 1e-2)
    after = dict(tr.model.named_parameters())
    assert torch.equal(after["bi_fpn.w"], before["bi_fpn.w"]) != train_bifpn
    assert tr.optimizer.state()["trace"]["bi_fpn.w"].abs().sum() > 0
    assert not torch.equal(after["cv3_0_2.weight"], before["cv3_0_2.weight"])


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fold_opt_state_round_trip_is_exact(opt):
    """fold_opt_state permutes exactly the parameter-keyed dicts, like the
    parameters, and passes Adam's count through."""
    cfg = ModelConfig(num_classes=1, phi="n", input_shape=(64, 64))
    model = DCFAYolo(cfg)
    tr = Trainer(model, TrainConfig(optimizer_type=opt), device="cpu")
    slots = ("trace",) if opt == "sgd" else ("mu", "nu")
    state = tr.optimizer.state()
    state = {k: ({n: torch.arange(t.numel(), dtype=torch.float32).reshape(t.shape)
                  for n, t in v.items()} if isinstance(v, dict) else 5)
             for k, v in state.items()}
    spec = shuffle_fold_spec(model.state_dict())
    folded = fold_opt_state(state, spec)
    back = fold_opt_state(folded, spec, inverse=True)
    for slot in slots:
        np.testing.assert_equal(set(folded[slot]), set(state[slot]))
        ref = apply_shuffle_spec(state[slot], spec)
        for name, t in state[slot].items():
            assert torch.equal(back[slot][name], t)
            assert torch.equal(folded[slot][name], ref[name])
    key = spec[0][0]
    assert not torch.equal(folded[slots[0]][key], state[slots[0]][key])
    if opt == "adam":
        assert folded["count"] == back["count"] == 5


def test_cli_module_runs_as_a_script(tmp_path):
    """`python -m dcfa_yolo_tpu_torch.train --help` parses in a fresh
    process (no JAX is imported)."""
    proc = subprocess.run([sys.executable, "-m", "dcfa_yolo_tpu_torch.train", "--help"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--train-stem" in proc.stdout and "--device" in proc.stdout


def _to_flax(sd):
    """Port state_dict → flax variables tree (tests/test_torch_pipeline.py)."""
    import jax.numpy as jnp

    tree = {"params": {}, "batch_stats": {}}
    for key, v in sd.items():
        *scopes, leaf = key.split(".")
        v = v.numpy()
        if leaf == "weight" and v.ndim == 4:
            coll, leaf, v = "params", "kernel", v.transpose(2, 3, 1, 0)
        elif leaf == "weight":
            coll, leaf = "params", "scale"
        elif leaf in ("running_mean", "running_var"):
            coll, leaf = "batch_stats", leaf[len("running_"):]
        else:
            coll = "params"
        node = tree[coll]
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = jnp.asarray(v)
    return tree


def test_get_map_txt_writes_the_jax_lines(tmp_path):
    """The port's predictor and the JAX one, on the same weights at float32,
    write the same detection-results lines (the EvalCallback's conf 0.05,
    NMS 0.5, top-100)."""
    from dcfa_yolo_tpu.infer.predictor import YOLOPredictor as JaxPredictor
    from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor

    cfg = ModelConfig(num_classes=2, phi="n", input_shape=(64, 64))
    sd = init_model(cfg, 1, "cpu").state_dict()
    kw = dict(input_shape=(64, 64), confidence=0.05, nms_iou=0.5, max_det=100)
    jp = JaxPredictor(class_names=["a", "b"], variables=_to_flax(sd), **kw)
    pp = YOLOPredictor(["a", "b"], state_dict=sd, device="cpu", **kw)
    rng = np.random.default_rng(2)
    total = 0
    for i, hw in enumerate([(72, 96), (64, 64), (90, 60)]):
        rgb = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        nir = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
        jp.get_map_txt(f"{i}", rgb, nir, ["a", "b"], str(tmp_path / "jax"))
        pp.get_map_txt(f"{i}", rgb, nir, ["a", "b"], str(tmp_path / "port"))
        ref = (tmp_path / "jax" / "detection-results" / f"{i}.txt").read_text()
        got = (tmp_path / "port" / "detection-results" / f"{i}.txt").read_text()
        assert got == ref
        total += len(ref.splitlines())
    assert total > 0
    pp.get_map_txt_batch(["b0", "b1"], np.stack([rgb, rgb]), np.stack([nir, nir]),
                         ["a", "b"], str(tmp_path / "port"))
    assert ((tmp_path / "port" / "detection-results" / "b1.txt").read_text()
            == (tmp_path / "jax" / "detection-results" / "2.txt").read_text())
