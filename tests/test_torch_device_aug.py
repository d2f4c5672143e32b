"""Augmentation on the device (dcfa_yolo_tpu_torch/data/device_aug.py)
against the JAX package's (dcfa_yolo_tpu/data/device_aug.py) on the CPU,
and the training CLI's `--device-aug --remat`.

The same staged arrays and the same `GeomParams` go through both programs
(one jitted JAX program for the module's shape).  Tolerances: the sampler,
the staging and the loader's index stream are equal (the same numpy
draws and PIL resizes); the float32 program's pixels within 2e-5 on the
[0, 1] output (about 0.005 of a uint8 step: summation orders differ), its
boxes, labels and masks equal (the boxes' scale-and-offset rounds once,
as XLA's fused multiply-add does).  Two gloo ranks' slices of the global
batch are the one-process batch's rows, bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dcfa_yolo_tpu.data import device_aug as jda
from dcfa_yolo_tpu_torch.data import device_aug as pda
from dcfa_yolo_tpu_torch.data import voc
from dcfa_yolo_tpu_torch.data.augment import _merge_mosaic_boxes
from dcfa_yolo_tpu_torch.parallel import dryrun
from dcfa_yolo_tpu_torch.parallel.mesh import run_ranks
from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset
from dcfa_yolo_tpu_torch.train.__main__ import run as train_cli
from dcfa_yolo_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

OUT_HW = (64, 72)   # the program's canvas
STAGE = (48, 56)    # staging resolution
T = 8               # staged boxes per item = the program's max_boxes
B = 2


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    """Six pairs of three sizes with 2-10 boxes; item 5 has ten boxes
    (staging overflow at max_boxes 8)."""
    d = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    out = []
    for i in range(6):
        iw, ih = [(120, 90), (80, 100), (96, 96)][i % 3]
        paths = []
        for mod in ("rgb", "nir"):
            p = str(d / f"{i}_{mod}.png")
            Image.fromarray(rng.integers(0, 256, (ih, iw, 3), dtype=np.uint8)).save(p)
            paths.append(p)
        boxes = []
        for j in range(10 if i == 5 else 2 + i):
            x1, y1 = int(rng.integers(0, iw - 30)), int(rng.integers(0, ih - 30))
            boxes.append(f"{x1},{y1},{x1 + 8 + 2 * j},{y1 + 10 + j},{j % 3}")
        out.append(" ".join(paths + boxes))
    return out


@pytest.fixture(scope="module")
def staged(lines):
    return pda.stage_pairs(lines, STAGE, T)


def _tied_item(ds):
    """The staged set with item 0's boxes replaced by six copies of one box
    with labels 0-5: equal areas wherever they are pasted."""
    boxes, nbox = ds.boxes.copy(), ds.nbox.copy()
    boxes[0] = 0.0
    boxes[0, :6] = [0.2, 0.25, 0.55, 0.6, 0.0]
    boxes[0, :6, 4] = np.arange(6)
    nbox[0] = 6
    return ds._replace(boxes=boxes, nbox=nbox)


def _inert(b=B):
    return pda.GeomParams(
        idx=np.zeros((b, 5), np.int32), mode=np.zeros((b,), np.float32),
        mix=np.zeros((b,), np.float32), preflip=np.zeros((b, 5), np.float32),
        postflip=np.zeros((b, 5), np.float32), nw=np.ones((b, 5), np.float32),
        nh=np.ones((b, 5), np.float32), dx=np.full((b, 5), -4.0, np.float32),
        dy=np.full((b, 5), -4.0, np.float32), cut=np.zeros((b, 2), np.float32),
        hsv=np.ones((b, 3), np.float32))


def _geom(p, row, slot, nw, nh, dx, dy):
    p.nw[row, slot], p.nh[row, slot], p.dx[row, slot], p.dy[row, slot] = nw, nh, dx, dy


def _case(name, ds):
    """(params, dataset) of one fixed case; row 1 is a second plain sample."""
    p = _inert()
    p.idx[:] = [[1] * 5, [2] * 5]
    _geom(p, 1, 0, 50, 40, 9, 12)
    if name == "plain":
        _geom(p, 0, 0, 61, 47, 5, 8)
    elif name == "postflip":
        _geom(p, 0, 0, 61, 47, 5, 8)
        p.postflip[:, 0] = 1.0
    elif name == "mosaic_preflip":
        p.mode[0] = 1.0
        p.idx[0, :4] = [3, 1, 5, 4]
        p.cut[0] = (30, 27)
        p.preflip[0, :4] = [1, 0, 1, 1]
        for s, g in enumerate([(35, 30, -5, -3), (40, 44, -10, 27),
                               (45, 41, 30, 27), (38, 33, 30, -6)]):
            _geom(p, 0, s, *g)
        p.hsv[0] = (1.07, 0.6, 1.3)
    elif name == "mixup":
        _geom(p, 0, 0, 61, 47, 5, 8)
        p.mix[0] = 1.0
        p.idx[0, 4] = 4
        _geom(p, 0, 4, 80, 70, -9, -5)
        p.postflip[0, 4] = 1.0
    elif name == "val_letterbox":
        smp = pda.ParamSampler(ds, OUT_HW, train=False)
        p = smp.sample(np.random.Generator(np.random.PCG64(0)), np.array([0, 1]))
    elif name == "nw_clamped":
        _geom(p, 0, 0, 1, 47, 20, 8)
        _geom(p, 1, 0, 50, 1, 9, 30)
    elif name == "negative_dx":
        _geom(p, 0, 0, 90, 60, -23, -11)
    elif name == "tied_areas":
        # 12 valid boxes of one area (the item pasted twice by mixup) for 8
        # slots: the first 8 in slot order are kept
        ds = _tied_item(ds)
        p.idx[0] = 0
        _geom(p, 0, 0, 50, 45, 6, 7)
        _geom(p, 0, 4, 50, 45, 6, 7)
        p.mix[0] = 1.0
    elif name == "sampled":
        smp = pda.ParamSampler(ds, OUT_HW, mosaic_prob=1.0, mixup_prob=1.0,
                               epoch_length=100)
        smp.set_epoch(0)
        p = smp.sample(np.random.Generator(np.random.PCG64(5)), np.array([4, 5]))
    return p, ds


@pytest.fixture(scope="module")
def jax_program():
    return jax.jit(jda.make_device_augment(OUT_HW, T))


CASES = ["plain", "postflip", "mosaic_preflip", "mixup", "val_letterbox",
         "nw_clamped", "negative_dx", "tied_areas", "sampled"]


@pytest.mark.parametrize("case", CASES)
def test_float32_program_matches_jax(staged, jax_program, case):
    p, ds = _case(case, staged)
    arrays = (ds.images, ds.boxes, ds.nbox, p.idx)
    ref = [np.asarray(x) for x in jax_program(
        *(jnp.asarray(a) for a in arrays), jda.GeomParams(*(jnp.asarray(x) for x in p)))]
    tp = pda.GeomParams(*(torch.from_numpy(np.asarray(x)) for x in p))
    got = [x.numpy() for x in pda.make_device_augment(OUT_HW, T)(
        *(torch.from_numpy(a) for a in arrays), tp)]
    for name, a, r in zip(("rgb", "nir"), got[:2], ref[:2]):
        assert a.shape == r.shape == (B, *OUT_HW, 3) and a.dtype == np.float32
        np.testing.assert_allclose(a, r, rtol=0, atol=2e-5, err_msg=name)
    for name, a, r in zip(("gt_boxes", "gt_labels", "gt_mask"), got[2:], ref[2:]):
        np.testing.assert_array_equal(a, r, err_msg=name)
    if case == "tied_areas":
        assert ref[4][0].sum() == T and list(ref[3][0]) == [0, 1, 2, 3, 4, 5, 0, 1]


def test_bf16_program_keeps_the_boxes(staged):
    """bf16 resampling (on the CPU: bf16 operands in a float32 GEMM) leaves
    the box outputs bit-equal and the pixels within a uint8 step of the
    float32 program's."""
    p, ds = _case("sampled", staged)
    args = [torch.from_numpy(np.asarray(a)) for a in (ds.images, ds.boxes, ds.nbox, p.idx)]
    tp = pda.GeomParams(*(torch.from_numpy(np.asarray(x)) for x in p))
    f32 = pda.make_device_augment(OUT_HW, T)(*args, tp)
    bf16 = pda.make_device_augment(OUT_HW, T, resample_dtype=torch.bfloat16,
                                   out_dtype=torch.bfloat16)(*args, tp)
    assert bf16[0].dtype == torch.bfloat16
    for a, b in zip(f32[2:], bf16[2:]):
        assert torch.equal(a, b)
    assert 0 < float((bf16[0].float() - f32[0]).abs().mean()) * 255 < 1.0


def test_merge_quadrants_matches_the_host_merge():
    """`_merge_quadrants` == the port's host `_merge_mosaic_boxes` (the
    reference's `merge_bboxes`), over random boxes incl. degenerate ones."""
    rng = np.random.default_rng(7)
    boxes = np.zeros((4, 12, 5), np.float32)
    valid = np.zeros((4, 12), bool)
    for s in range(4):
        n = int(rng.integers(3, 12))
        x1, y1 = rng.uniform(0, 200, n), rng.uniform(0, 200, n)
        boxes[s, :n] = np.stack([x1, y1, x1 + rng.uniform(2, 80, n),
                                 y1 + rng.uniform(2, 80, n), rng.integers(0, 3, n)], -1)
        valid[s, :n] = True
    got_b, got_v = pda._merge_quadrants(torch.from_numpy(boxes), torch.from_numpy(valid),
                                        97.0, 123.0)
    got = got_b.numpy()[got_v.numpy()]
    ref = _merge_mosaic_boxes([boxes[s][valid[s]] for s in range(4)], 97, 123)
    assert len(got) == len(ref) > 0
    np.testing.assert_allclose(np.sort(got, 0), np.sort(ref, 0), atol=1e-4)


@pytest.mark.parametrize("max_boxes", [3, 16])
def test_staging_matches_jax(lines, max_boxes):
    got = pda.stage_pairs(lines, STAGE, max_boxes)
    ref = jda.stage_pairs(lines, STAGE, max_boxes)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    # items 2-5 hold 4, 5, 6 and 10 boxes
    assert (got.overflow_items, got.overflow_dropped) == ((4, 13) if max_boxes == 3
                                                          else (0, 0))


@pytest.mark.parametrize("train", [True, False])
def test_param_sampler_matches_jax(staged, train):
    """Several batches in each of several epochs, across the mosaic gate at
    epoch_length·special_aug_ratio = 7: identical GeomParams."""
    kw = dict(train=train, epoch_length=10, special_aug_ratio=0.7)
    ours = pda.ParamSampler(staged, OUT_HW, **kw)
    theirs = jda.ParamSampler(jda.StagedDataset(*staged), OUT_HW, **kw)
    mosaics = {True: 0, False: 0}  # by epoch inside the gate
    for epoch in (0, 3, 6, 7, 9):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        ra, rb = (np.random.Generator(np.random.PCG64(epoch)) for _ in range(2))
        for _ in range(3):
            idx = ra.permutation(6)[:4]
            assert np.array_equal(idx, rb.permutation(6)[:4])
            a, b = ours.sample(ra, idx), theirs.sample(rb, idx)
            for name, x, y in zip(a._fields, a, b):
                np.testing.assert_array_equal(x, y, err_msg=name)
            mosaics[epoch < 7] += int(a.mode.sum())
    assert mosaics[False] == 0 and (mosaics[True] > 0) == train


def test_loader_index_stream_matches_jax(staged):
    """The loader's shuffle, ragged-tail padding and per-epoch parameter
    stream (set_epoch, and an epoch without it) equal the JAX loader's."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    kw = dict(staged=staged, seed=3, drop_last=False, epoch_length=4, max_boxes=T)
    ours = pda.DeviceAugLoader(["s"] * 6, OUT_HW, 4, device="cpu", **kw)
    theirs = jda.DeviceAugLoader(["s"] * 6, OUT_HW, 4, mesh, **kw)
    seen = {"ours": [], "theirs": []}
    ours.augment_batch = lambda idx, p: seen["ours"].append(p)
    theirs.augment_batch = lambda idx, p: seen["theirs"].append(p)
    assert len(ours) == len(theirs) == 2
    for ld in (ours, theirs):
        ld.set_epoch(2)
        list(ld)
        list(ld)  # epoch 3, no set_epoch
    assert len(seen["ours"]) == len(seen["theirs"]) == 4
    for a, b in zip(seen["ours"], seen["theirs"]):
        for name, x, y in zip(a._fields, a, b):
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_two_ranks_slice_the_global_batch(staged, tmp_path):
    """2 gloo ranks each augment their half of every global batch (the
    parameters drawn from the one stream), bit for bit the rows of the
    one-process loader's batch."""
    spec = dict(staged=tuple(staged[:4]), input_shape=OUT_HW, batch_size=4, epochs=2,
                loader=dict(max_boxes=T, seed=1, mosaic_prob=1.0, mixup_prob=1.0,
                            epoch_length=10))
    halves = run_ranks(dryrun.aug_rank, 2, (spec,), store_dir=str(tmp_path))
    whole = dryrun.aug_rank(0, 1, None, spec)
    assert len(whole) == len(halves[0]) == len(halves[1]) == 2
    for j, batch in enumerate(whole):
        for k, v in batch.items():
            np.testing.assert_array_equal(
                np.concatenate([halves[0][j][k], halves[1][j][k]]), v, err_msg=k)


def test_loader_batches_are_device_batches(staged):
    ld = pda.DeviceAugLoader(["s"] * 6, OUT_HW, 4, staged=staged, device="cpu",
                             max_boxes=T, out_dtype=torch.bfloat16, epoch_length=10)
    assert ld.throughput() is None and (ld.overflow_items, ld.overflow_dropped) == (1, 2)
    b = next(iter(ld))
    assert b.rgb.shape == (4, *OUT_HW, 3) and b.rgb.dtype == torch.bfloat16
    assert b.gt_boxes.shape == (4, T, 4) and b.gt_mask.dtype == torch.float32
    with pytest.raises(ValueError, match="device memory"):
        pda.DeviceAugLoader(["s"] * 6, OUT_HW, 4, staged=staged, device="cpu",
                            max_hbm_gb=1e-6)


def test_entry_points_raise_without_cuda(staged):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device is usable")
    from dcfa_yolo_tpu_torch.tools import bench_device_aug

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pda.DeviceAugLoader(["s"] * 6, OUT_HW, 4, staged=staged)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_device_aug.run(pairs=2, batch_size=2, size=32)
    out = bench_device_aug.run(pairs=4, batch_size=2, size=32, iters=1, device="cpu")
    assert out["device"] == "cpu" and out["aug_train_step_ms"] > 0


def test_cli_trains_an_epoch_with_device_aug_and_remat(tmp_path, monkeypatch):
    """`--device-aug --remat --device cpu`: the model rematerializes, the
    loops take the loader's device batches (`put_batch` is never called),
    and the losses are finite."""
    make_dataset(str(tmp_path), 6, (160, 120))
    devkit = str(tmp_path / "VOCdevkit")
    voc.generate_imagesets(devkit, trainval_percent=1.0, train_percent=0.67)
    classes = str(tmp_path / "model_data" / "voc_classes.txt")
    voc.generate_annotation_files(devkit, classes, out_dir=str(tmp_path), image_ext=".png")

    def refuse(*a, **k):
        raise AssertionError("put_batch called under --device-aug")

    monkeypatch.setattr(Trainer, "put_batch", refuse)
    r = train_cli(["--classes-path", classes,
                   "--train-annotation", str(tmp_path / "2007_train.txt"),
                   "--val-annotation", str(tmp_path / "2007_val.txt"),
                   "--input-shape", "64", "64", "--batch-size", "2",
                   "--compute-dtype", "float32", "--unfreeze-epoch", "1", "--no-eval",
                   "--save-dir", str(tmp_path / "logs"), "--device", "cpu",
                   "--device-aug", "--device-aug-stage", "48", "48", "--remat"])
    e = r["epochs"][0]
    assert r["trainer"].model.cfg.remat and e["steps"] == 2 and e["loader_capacity"] is None
    assert np.isfinite(e["loss"]) and np.isfinite(e["val_loss"]) and e["val_loss"] > 0
