"""The port's spans (`dcfa_yolo_tpu_torch/utils/profiling.py::span`) on the
CPU: off unless a `torch.profiler` session records, and then one
`record_function` range in the exported trace and one record each, nested
under the predictor's call, the train step and the loader's batch."""

from __future__ import annotations

import json
import re
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
from dcfa_yolo_tpu_torch.data import voc
from dcfa_yolo_tpu_torch.data.device_aug import DeviceAugLoader
from dcfa_yolo_tpu_torch.infer import pipeline
from dcfa_yolo_tpu_torch.infer.predictor import YOLOPredictor
from dcfa_yolo_tpu_torch.models.yolo import init_model
from dcfa_yolo_tpu_torch.profile_train import synthetic_batch
from dcfa_yolo_tpu_torch.tools.make_synth_dataset import make_dataset
from dcfa_yolo_tpu_torch.train.__main__ import run as train_cli
from dcfa_yolo_tpu_torch.train.trainer import Trainer
from dcfa_yolo_tpu_torch.utils import profiling

torch.set_num_threads(1)
PORT = Path(__file__).resolve().parent.parent / "dcfa_yolo_tpu_torch"
HW = (64, 64)
STAGES = ("trainer.forward", "trainer.loss", "trainer.backward", "trainer.reduce",
          "trainer.update")
# the benchmark's own range labels (benchmark/benchlib/trace.py keeps only
# ranges with these names)
BENCH_LABELS = {"window", "detect", "augment", "train_step", "step"}


@pytest.fixture(scope="module")
def predictor():
    return YOLOPredictor(["obj"], input_shape=HW, device="cpu")


@pytest.fixture(scope="module")
def trainer():
    tc = TrainConfig()
    tr = Trainer(init_model(ModelConfig(num_classes=1, input_shape=HW), 0, "cpu",
                            train=True), tc, device="cpu")
    return tr, tr.put_batch(*synthetic_batch(2, HW, tc.max_boxes, seed=0))


@pytest.fixture(scope="module")
def loader(tmp_path_factory):
    d = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(4):
        paths = []
        for mod in ("rgb", "nir"):
            p = str(d / f"{i}_{mod}.png")
            Image.fromarray(rng.integers(0, 256, (48, 56, 3), dtype=np.uint8)).save(p)
            paths.append(p)
        lines.append(" ".join(paths + [f"{4 + i},6,30,40,0"]))
    return DeviceAugLoader(lines, HW, 2, max_boxes=4, mosaic=False, mixup=False,
                           device="cpu")


def _call(predictor):
    img = np.zeros((48, 64, 3), np.uint8)
    predictor.detect(img, img)


def _step(trainer):
    tr, batch = trainer
    tr.train_step(batch, 1e-3)


def _batches(loader, gap_s=0.0):
    """Two batches; the consumer sleeps `gap_s` after each.  Returns the
    consumer's sleeps [(start ns, end ns)]."""
    sleeps = []
    it = iter(loader)
    for _ in range(2):
        next(it)
        t = time.perf_counter_ns()
        time.sleep(gap_s)
        sleeps.append((t, time.perf_counter_ns()))
    return sleeps


RUNS = {"predictor": (_call, "predictor"), "trainer": (_step, "trainer"),
        "loader": (_batches, "loader")}


@pytest.fixture
def recorded():
    profiling.clear_spans()
    yield profiling.recorded_spans
    profiling.clear_spans()


@pytest.fixture
def spies(monkeypatch):
    """Counts entries of `record_function` and calls of the device waits."""
    seen = {"record_function": 0, "synchronize": 0}
    real = torch.autograd.profiler.record_function

    class Spy(real):
        def __enter__(self):
            seen["record_function"] += 1
            return super().__enter__()

    def sync(*a, **k):
        seen["synchronize"] += 1

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Spy)
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    return seen


def _tree(records):
    by_id = {r.id: r for r in records}
    return by_id, [r for r in records if r.parent is None]


@pytest.mark.parametrize("what", list(RUNS))
def test_off_without_a_profiler(request, recorded, spies, what):
    fn, fixture = RUNS[what]
    fn(request.getfixturevalue(fixture))
    assert recorded() == []
    assert spies == {"record_function": 0, "synchronize": 0}


def test_span_off_is_one_shared_no_op():
    assert profiling.span("a") is profiling.span("b", request=3)


def test_predictor_call_records_its_copy_out(predictor, recorded, spies):
    with profile(activities=[ProfilerActivity.CPU]):
        _call(predictor)
    by_id, roots = _tree(recorded())
    assert [r.name for r in roots] == ["predictor.call"]
    assert roots[0].request == predictor.calls
    kids = [r for r in by_id.values() if r.parent == roots[0].id]
    assert [r.name for r in kids] == ["predictor.copy_out"]
    assert {r.request for r in by_id.values()} == {predictor.calls}
    assert roots[0].start_ns <= kids[0].start_ns <= kids[0].end_ns <= roots[0].end_ns
    assert spies["synchronize"] == 0 and spies["record_function"] == 2


def test_train_step_records_its_five_stages(trainer, recorded):
    with profile(activities=[ProfilerActivity.CPU]):
        _step(trainer)
    by_id, roots = _tree(recorded())
    assert [r.name for r in roots] == ["trainer.step"]
    kids = sorted((r for r in by_id.values() if r.parent == roots[0].id),
                  key=lambda r: r.start_ns)
    assert tuple(r.name for r in kids) == STAGES
    assert {r.request for r in by_id.values()} == {trainer[0].steps}
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))


def test_loader_batch_leaves_out_the_consumer(loader, recorded):
    with profile(activities=[ProfilerActivity.CPU]):
        sleeps = _batches(loader, gap_s=0.05)
    by_id, roots = _tree(recorded())
    assert [r.name for r in roots] == ["device_aug.batch"] * 2
    assert [r.request for r in roots] == [loader.batches - 1, loader.batches]
    for root in roots:
        kids = [r.name for r in by_id.values() if r.parent == root.id]
        assert kids == ["device_aug.sample", "device_aug.program"]
        for a, b in sleeps:
            assert root.end_ns <= a or root.start_ns >= b


def test_replay_spans_nest_under_the_call(monkeypatch, recorded):
    """The graph path's spans, with the capture replaced by a stand-in (a
    CUDA graph needs the card): copy in and capture on a new key, then copy
    in and replay, on every call."""

    class Graph:
        def replay(self):
            pass

    def capture(model, fn, inputs):
        pipeline._GRAPHS[model] = {"pool": None, "graphs": {}}
        return pipeline._Graph(Graph(), inputs, fn(*inputs), [0, 0])

    monkeypatch.setattr(pipeline, "_capture", capture)
    model = torch.nn.Linear(1, 1)
    x = torch.ones(3)
    with profile(activities=[ProfilerActivity.CPU]):
        for n in (1, 2):
            with profiling.span("predictor.call", request=n):
                pipeline._replay(model, "key", lambda a: (a * 2,), (x,))
    by_id, roots = _tree(recorded())
    names = [[r.name for r in sorted(by_id.values(), key=lambda r: r.start_ns)
              if r.parent == root.id] for root in roots]
    assert names == [["pipeline.copy_in", "pipeline.capture", "pipeline.copy_in",
                      "pipeline.replay"], ["pipeline.copy_in", "pipeline.replay"]]
    assert [r.request for r in roots] == [1, 2]


@pytest.mark.parametrize("what", list(RUNS))
def test_spans_are_in_the_exported_trace(request, recorded, tmp_path, what):
    fn, fixture = RUNS[what]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(request.getfixturevalue(fixture))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = sorted(e["name"] for e in events
                       if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    assert annotated == sorted(r.name for r in recorded())


def test_span_names_are_not_the_benchmarks_labels():
    names = set()
    for f in PORT.rglob("*.py"):
        names |= set(re.findall(r'\bspan\("([^"]+)"', f.read_text()))
    assert names == {"predictor.call", "predictor.copy_out", "pipeline.copy_in",
                     "pipeline.capture", "pipeline.replay", "trainer.step", *STAGES,
                     "trainer.capture", "trainer.replay",
                     "device_aug.batch", "device_aug.sample", "device_aug.program"}
    assert not names & BENCH_LABELS


def test_the_ring_keeps_the_newest():
    rec = profiling.SpanRecorder(capacity=3)
    for i in range(5):
        rec.records.append(profiling.SpanRecord(i, "s", 0, 1, None, i))
    assert [r.id for r in rec.records] == [2, 3, 4]
    assert profiling.SPAN_RING == 65536


def test_device_busy_is_the_union_of_device_intervals():
    """Two overlapping kernels (100-300, 200-400) and a copy apart
    (600-700) are 400 µs busy, not the 500 their sum reads; host events
    and the device side of a `record_function` range are not operations."""
    from torch.autograd import DeviceType

    class Ev:
        def __init__(self, a, b, dev=DeviceType.CUDA, annotation=False):
            self.time_range = SimpleNamespace(start=a, end=b)
            self.device_type, self.is_user_annotation = dev, annotation

    class Prof:
        def events(self):
            return [Ev(200, 400), Ev(100, 300), Ev(600, 700), Ev(0, 900, DeviceType.CPU),
                    Ev(0, 900, annotation=True)]

    busy, n = profiling.device_busy(Prof())
    assert busy == pytest.approx(400e-6) and n == 3


def test_cli_profile_dir_holds_the_stages(tmp_path):
    make_dataset(str(tmp_path / "d"), 4, (160, 120))
    devkit = str(tmp_path / "d" / "VOCdevkit")
    voc.generate_imagesets(devkit, trainval_percent=1.0, train_percent=1.0)
    classes = str(tmp_path / "d" / "model_data" / "voc_classes.txt")
    voc.generate_annotation_files(devkit, classes, out_dir=str(tmp_path / "d"),
                                  image_ext=".png")
    ann = str(tmp_path / "d" / "2007_train.txt")
    prof = tmp_path / "prof"
    train_cli(["--classes-path", classes, "--train-annotation", ann,
               "--val-annotation", ann, "--input-shape", "64", "64", "--batch-size", "2",
               "--compute-dtype", "float32", "--unfreeze-epoch", "1", "--no-eval",
               "--num-workers", "1", "--save-dir", str(tmp_path / "logs"),
               "--device", "cpu", "--profile-dir", str(prof)])
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"trainer.step", "trainer.forward"} <= names
