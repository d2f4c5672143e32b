"""The port's host data path (dcfa_yolo_tpu_torch/data/) against the JAX
package's (dcfa_yolo_tpu/data/), on the same files.

The JAX augmentation draws from the global `np.random` and `random`
streams; the port from the generators it is handed.  Seeding the JAX
globals and the port's generators alike must give the same geometry:
boxes exactly equal, and pixels too, since both resize and paste with PIL
and jitter HSV with cv2.
"""

from __future__ import annotations

import contextlib
import importlib.util
import os
import random
import runpy
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from dcfa_yolo_tpu.data import augment as jaug
from dcfa_yolo_tpu.data import voc as jvoc
from dcfa_yolo_tpu.data.loader import BatchLoader as JaxBatchLoader
from dcfa_yolo_tpu.data.loader import PairedDetectionDataset as JaxDataset
from dcfa_yolo_tpu_torch.data import augment, voc
from dcfa_yolo_tpu_torch.data.loader import BatchLoader, PairedDetectionDataset

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    """Six pairs of random images of two sizes, with distinct-area boxes."""
    d = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    out = []
    for i in range(6):
        h, w = (90, 120) if i % 2 else (100, 80)
        paths = []
        for mod in ("rgb", "nir"):
            p = str(d / f"{i}_{mod}.png")
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(p)
            paths.append(p)
        boxes = []
        for j in range(3 + i):
            x1, y1 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
            boxes.append(f"{x1},{y1},{x1 + 10 + 3 * j + i},{y1 + 12 + 2 * j},{j % 2}")
        out.append(" ".join(paths + boxes))
    return out


def _seed_both(seed):
    np.random.seed(seed)
    random.seed(seed)
    return np.random.RandomState(seed)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80), (80, 48), (32, 40)])
def test_letterbox_matches_jax(lines, hw):
    for k, line in enumerate(lines):
        rng = _seed_both(k)
        jr, jn, jb = jaug.load_pair_letterbox(line, hw)
        r, n, b = augment.load_pair_letterbox(line, hw, rng)
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(n, jn)
        np.testing.assert_array_equal(b, jb)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80), (80, 48), (32, 40)])
def test_random_path_matches_jax(lines, hw):
    for k in range(12):
        line = lines[k % len(lines)]
        rng = _seed_both(100 + k)
        jr, jn, jb = jaug.load_pair_random(line, hw)
        r, n, b = augment.load_pair_random(line, hw, rng)
        np.testing.assert_array_equal(b, jb)
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(n, jn)


def test_mosaic_and_mixup_match_jax(lines):
    hw = (64, 64)
    for k in range(6):
        picked = [lines[(k + j) % len(lines)] for j in range(4)]
        rng = _seed_both(200 + k)
        jr, jn, jb = jaug.load_mosaic(picked, hw)
        r, n, b = augment.load_mosaic(picked, hw, rng)
        np.testing.assert_array_equal(b, jb)
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(n, jn)
        # mixup with a train-path pair drawn next from the same streams
        jr2, jn2, jb2 = jaug.load_pair_random(lines[k], hw)
        r2, n2, b2 = augment.load_pair_random(lines[k], hw, rng)
        jm = jaug.mixup_pairs(jr, jn, jb, jr2, jn2, jb2)
        m = augment.mixup_pairs(r, n, b, r2, n2, b2)
        np.testing.assert_array_equal(m[2], jm[2])
        for got, ref in zip(m[:2], jm[:2]):
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("offset", [(-7, 5), (20, -3), (30, 30), (0, 0)])
def test_resize_paste_matches_jax(offset):
    """Negative and overflowing offsets clip as in the JAX package."""
    img = Image.fromarray(np.random.default_rng(1).integers(0, 256, (40, 50, 3),
                                                            dtype=np.uint8))
    np.testing.assert_array_equal(augment._resize_paste(img, (37, 29), (48, 44), *offset),
                                  jaug._resize_paste(img, (37, 29), (48, 44), *offset))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hsv_jitter_pair_matches_jax(seed):
    """The same gains drawn from the same stream, the same LUTs on both
    modalities, at a width that is not a multiple of cv2's vector block."""
    rng = np.random.default_rng(seed)
    rgb, nir = (rng.integers(0, 256, (24, 70, 3), dtype=np.uint8) for _ in range(2))
    gen = _seed_both(seed)
    ref = jaug._hsv_jitter_pair(rgb, nir, 0.1, 0.7, 0.4)
    got = augment._hsv_jitter_pair(rgb, nir, 0.1, 0.7, 0.4, gen)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_load_rgb_u8_matches_jax(tmp_path, mode):
    """Decoded to RGB uint8 as the JAX package decodes, from files of every
    common PNG mode; the result is writable."""
    rng = np.random.default_rng(len(mode))
    arr = rng.integers(0, 256, (30, 40, 4), dtype=np.uint8)
    img = Image.fromarray(arr, "RGBA").convert(mode)
    path = str(tmp_path / f"{mode}.png")
    img.save(path)
    got = augment.load_rgb_u8(path, cache=False)
    assert got.shape == (30, 40, 3) and got.dtype == np.uint8 and got.flags.writeable
    np.testing.assert_array_equal(got, jaug._load_rgb_u8(path, cache=False))


def test_decode_uses_the_cache(tmp_path):
    img = np.random.default_rng(6).integers(0, 256, (8, 9, 3), dtype=np.uint8)
    path = str(tmp_path / "c.png")
    Image.fromarray(img).save(path)
    a = augment.load_rgb_u8(path)
    assert a is augment.load_rgb_u8(path)
    np.testing.assert_array_equal(a, img)
    assert augment.load_rgb_u8(path, cache=False) is not a


def test_dataset_item_matches_jax(lines):
    """`load` draws mosaic, mixup and its `random.sample`s in the JAX
    dataset's order: the same boxes from the same seeds."""
    kw = dict(input_shape=(64, 64), train=True, mosaic=True, mosaic_prob=0.5,
              mixup=True, mixup_prob=0.5, epoch_length=10)
    jds, ds = JaxDataset(lines, **kw), PairedDetectionDataset(lines, **kw)
    jds.set_epoch(0)
    ds.set_epoch(0)
    for k in range(8):
        rng = _seed_both(300 + k)
        jitem = jds[k]
        item = ds.load(k, rng, random.Random(300 + k))
        np.testing.assert_array_equal(item[2], jitem[2])
        assert item[0].shape == jitem[0].shape


def test_merge_and_clip_are_the_jax_functions(lines):
    rng = np.random.default_rng(3)
    tiles = [np.concatenate([rng.uniform(0, 60, (5, 2)), rng.uniform(0, 60, (5, 2)) + 20,
                             rng.integers(0, 2, (5, 1))], 1) for _ in range(4)]
    np.testing.assert_array_equal(augment._merge_mosaic_boxes(tiles, 31, 27),
                                  jaug._merge_mosaic_boxes(tiles, 31, 27))
    b = np.concatenate([rng.uniform(-10, 70, (8, 4)), np.zeros((8, 1))], 1)
    np.testing.assert_array_equal(augment._clip_filter_boxes(b.copy(), 64, 48),
                                  jaug._clip_filter_boxes(b.copy(), 64, 48))


def _sorted_gt(hb, i):
    keep = hb.gt_mask[i] > 0
    rows = np.concatenate([hb.gt_boxes[i][keep], hb.gt_labels[i][keep][:, None]], 1)
    return rows[np.lexsort(rows.T[::-1])]


def test_batch_loader_val_path_matches_jax(lines):
    """The val path, shuffled: the PCG64(seed + epoch) order, the tail padded
    by repetition with sample_mask 0, the largest-area max_boxes cap and its
    counters, as the JAX loader; box order within an image is drawn per
    loader, so boxes are compared as sets."""
    kw = dict(input_shape=(64, 64), train=False, mosaic=False, mixup=False)
    lkw = dict(batch_size=4, max_boxes=6, shuffle=True, drop_last=False,
               num_workers=2, seed=5)
    jl = JaxBatchLoader(JaxDataset(lines, **kw), **lkw)
    pl = BatchLoader(PairedDetectionDataset(lines, **kw), **lkw)
    for epoch in (0, 3):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(pb) == len(jb) == 2
        np.testing.assert_array_equal(pb[1].sample_mask, [1, 1, 0, 0])
        np.testing.assert_array_equal(pb[0].sample_mask, [1, 1, 1, 1])
        for a, b in zip(pb, jb):
            np.testing.assert_array_equal(a.rgb, b.rgb)
            np.testing.assert_array_equal(a.nir, b.nir)
            assert a.gt_boxes.shape == (4, 6, 4)
            for i in range(4):
                np.testing.assert_array_equal(_sorted_gt(a, i), _sorted_gt(b, i))
        assert (pl.overflow_items, pl.overflow_dropped) == (jl.overflow_items,
                                                            jl.overflow_dropped)
        assert pl.overflow_items > 0
        assert pl.throughput() > 0


def test_train_batches_repeat_at_any_worker_count(lines):
    """Each item draws from generators seeded by (seed, epoch, position), so
    mosaic + mixup batches do not depend on the thread pool."""
    kw = dict(input_shape=(64, 64), train=True, mosaic=True, mixup=True, epoch_length=10)
    runs = []
    for workers in (1, 3):
        ds = PairedDetectionDataset(lines, **kw)
        ds.set_epoch(1)
        loader = BatchLoader(ds, 2, max_boxes=8, num_workers=workers, seed=11)
        loader.set_epoch(1)
        runs.append(list(loader))
    for a, b in zip(*runs):
        for name in ("rgb", "nir", "gt_boxes", "gt_labels", "gt_mask", "sample_mask"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def _load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_make_synth_dataset", REPO / "tools" / "make_synth_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synth_dataset_and_voc_split_match_jax(tmp_path):
    """The port's synthetic dataset has the JAX tool's geometry (the same
    annotations) and nearly its pixels (ellipses rasterised by numpy); the
    port's voc.py writes the JAX voc.py's splits and annotation lines."""
    from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset

    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _load_jax_tool().main(jdir, 3)
    make_dataset(pdir, 3)
    for i in range(3):
        fid = f"{i:06d}"
        ann = [Path(d, "VOCdevkit/VOC2007/Annotations", fid + ".xml").read_text()
               for d in (jdir, pdir)]
        assert ann[0] == ann[1]
        for mod in ("rgb", "nir"):
            ref = np.asarray(Image.open(Path(jdir, f"VOCdevkit/VOC2007/JPEGImages_{mod}",
                                             fid + ".png")))
            got = np.asarray(Image.open(Path(pdir, f"VOCdevkit/VOC2007/JPEGImages_{mod}",
                                             fid + ".png")))
            assert got.shape == ref.shape == (360, 480, 3)
            assert (got == ref).all(-1).mean() >= 0.97
    classes = os.path.join(jdir, "model_data", "voc_classes.txt")
    assert voc.read_class_names(classes) == jvoc.read_class_names(classes)
    devkit = os.path.join(jdir, "VOCdevkit")
    splits = {}
    for name, mod in (("port", voc), ("jax", jvoc)):
        out = tmp_path / f"split_{name}"
        out.mkdir()
        assert mod.generate_imagesets(devkit, 1.0, 0.67) == {"trainval": 3, "train": 2,
                                                             "val": 1, "test": 0}
        mod.generate_annotation_files(devkit, classes, out_dir=str(out))
        splits[name] = [(out / f"2007_{s}.txt").read_text() for s in ("train", "val")]
    assert splits["port"] == splits["jax"]
    png = tmp_path / "png"
    png.mkdir()
    voc.generate_annotation_files(devkit, classes, out_dir=str(png), image_ext=".png")
    assert (png / "2007_train.txt").read_text() == splits["jax"][0].replace(".jpg", ".png")


def test_loader_bench_reports_each_epoch():
    """tools/loader_bench.py drives the train loader (mosaic and mixup on)
    over a synthetic dataset and reports a rate per epoch."""
    from dcfa_yolo_tpu_torch.tools.loader_bench import run as loader_bench

    out = loader_bench(pairs=8, batch_size=2, num_workers=1, epochs=2, size=64)
    assert [e["batches"] for e in out["epochs"]] == [3, 3]
    assert all(e["wall_batches_per_s"] > 0 and e["capacity_batches_per_s"] > 0
               for e in out["epochs"])


def _written(cwd: Path, devkit: Path):
    """The files a voc_annotation run writes: the splits and the annotation
    files, by name."""
    sets = devkit / "VOC2007" / "ImageSets" / "Main"
    return {**{"ImageSets/" + p.name: p.read_bytes() for p in sets.glob("*.txt")},
            **{p.name: p.read_bytes() for p in cwd.glob("2007_*.txt")}}


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_voc_annotation_cli_writes_the_root_cli_files(tmp_path, monkeypatch, mode):
    """`python -m dcfa_yolo_tpu_torch.voc_annotation` against the root
    `voc_annotation.py` on one synthetic devkit: byte-equal files."""
    from dcfa_yolo_tpu_torch import voc_annotation
    from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset

    make_dataset(str(tmp_path / "data"), 5, (160, 120))
    devkit = tmp_path / "data" / "VOCdevkit"
    classes = str(tmp_path / "data" / "model_data" / "voc_classes.txt")
    argv = ["--annotation-mode", str(mode), "--vocdevkit-path", str(devkit),
            "--classes-path", classes, "--trainval-percent", "0.8"]
    if mode == 2:  # the annotation files read the splits of a mode-1 run
        voc.generate_imagesets(str(devkit), 0.8, 0.9, 0)
    out = {}
    for name in ("root", "port"):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        for f in devkit.rglob("ImageSets/Main/*.txt"):
            if mode != 2:
                f.unlink()
        if name == "root":
            monkeypatch.setattr("sys.argv", ["voc_annotation.py", *argv])
            with contextlib.redirect_stdout(None):
                runpy.run_path(str(REPO / "voc_annotation.py"), run_name="__main__")
        else:
            assert voc_annotation.main(argv) == 0
        out[name] = _written(cwd, devkit)
    assert out["port"] == out["root"]
    want = {0: 6, 1: 4, 2: 6}[mode]  # mode 2 reads the splits and writes 2 files
    assert len(out["port"]) == want and all(out["port"].values())
