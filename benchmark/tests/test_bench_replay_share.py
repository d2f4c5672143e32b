"""`replay_share.train` (`benchmark/metrics/replay_share.train.py`) on a
hand-made trace and span list: the share of the window's steps replayed
from the captured graph, and None where no step was."""

from __future__ import annotations

import pytest
from benchlib import spec
from benchlib.trace import Trace

SHIFT_US = 7.5e6  # the trace's clock less the program's


def _ctx(steps):
    """A traced window of steps, each in its `train_step` range; `steps`
    names each step's child spans."""
    ranges, recs, i = [], [], 0
    for k, kids in enumerate(steps):
        a = 1000.0 + 2000.0 * k
        ranges.append({"ph": "X", "cat": "user_annotation", "name": "train_step",
                       "ts": a, "dur": 1000.0})
        i += 1
        root = i
        recs.append((root, "trainer.step", a + 10, a + 990, None, root))
        for j, name in enumerate(kids):
            i += 1
            recs.append((i, name, a + 20 + 300 * j, a + 300 + 300 * j, root, root))
    tr = Trace(ranges, 2000.0 * len(steps) / 1e6, len(steps), labels=("train_step",))
    to_ns = lambda us: int(round((us - SHIFT_US) * 1e3))  # noqa: E731
    recs = [(i, n, to_ns(a), to_ns(b), p, q) for i, n, a, b, p, q in recs]
    return {"trace": tr, "records": recs}


@pytest.fixture
def read(monkeypatch):
    from benchlib import spans

    def run(ctx):
        monkeypatch.setattr(spans, "recorded", lambda: ctx.pop("records", None))
        return spec.metric_reader("replay_share.train").read(ctx)
    return run


def test_the_share_of_steps_replayed(read):
    steps = [["trainer.forward", "trainer.loss"], ["trainer.capture", "trainer.replay"],
             ["trainer.replay"], ["trainer.replay"]]
    assert read(_ctx(steps)) == pytest.approx(75.0)
    assert read(_ctx([["trainer.replay"]] * 3)) == pytest.approx(100.0)


def test_no_replay_reads_none(read):
    assert read(_ctx([["trainer.forward", "trainer.backward"]] * 3)) is None
    assert read({}) is None
