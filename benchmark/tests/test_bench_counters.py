"""The program's counters (`dcfa_yolo_tpu_torch.utils.profiling.count`) and
the readers of the data-parallel cell and the graph pool
(`benchlib/links.py`): off outside a profiler session; counted a step on
the eager, captured (the card, marked `cuda`) and data-parallel routes;
the readers' arithmetic on a hand-made trace, and None where the program
has no counters."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchlib import links
from benchlib.trace import Trace

HW = (64, 64)


def _trainer(dev="cpu", **kw):
    from dcfa_yolo_tpu_torch.config import ModelConfig, TrainConfig
    from dcfa_yolo_tpu_torch.models.yolo import init_model
    from dcfa_yolo_tpu_torch.train.trainer import Trainer

    return Trainer(init_model(ModelConfig(num_classes=1, input_shape=HW), 0, dev, train=True),
                   TrainConfig(max_boxes=8), device=dev, **kw)


def _batch(tr, b=2, rank=0, world=1):
    from dcfa_yolo_tpu_torch.parallel.mesh import shard_batch
    from dcfa_yolo_tpu_torch.profile_train import synthetic_batch

    return tr.put_batch(*shard_batch(synthetic_batch(b, HW, 8, seed=0), rank, world))


def _counted(tr, batch, steps):
    """The counters over `steps` steps: (untraced, traced)."""
    from dcfa_yolo_tpu_torch.utils import profiling

    profiling.clear_counters()
    for _ in range(steps):
        tr.train_step(batch, 1e-2)
    off = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(steps):
            tr.train_step(batch, 1e-2)
    return off, profiling.counters()


def test_counters_are_off_outside_a_profiler_session():
    from dcfa_yolo_tpu_torch.utils import profiling

    profiling.clear_counters()
    profiling.count("x", 5)
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("x", 5)
        profiling.count("x", 2)
        profiling.count("pool", 7, total=True)
        profiling.count("pool", 9, total=True)
    assert profiling.counters() == {"x": 7, "pool": 9}
    profiling.clear_counters()
    assert profiling.counters() == {}


def test_the_eager_step_counts_nothing():
    tr = _trainer()
    off, on = _counted(tr, _batch(tr), 2)
    assert off == {} and on == {}


def _dp_counts(rank, world, group):
    from dcfa_yolo_tpu_torch.ops.norm import BatchNorm

    tr = _trainer(group=group, step_mode="fused")
    off, on = _counted(tr, _batch(tr, 4, rank, world), 2)
    bn = [m for m in tr.model.modules() if isinstance(m, BatchNorm)]
    n_params = sum(p.numel() for p in tr.model.parameters())
    return off, on, len(bn), sum(m.weight.numel() for m in bn), n_params


def test_the_fused_data_parallel_step_counts_its_all_reduces():
    from dcfa_yolo_tpu_torch.parallel.mesh import run_ranks

    for off, on, n_bn, channels, n_params in run_ranks(_dp_counts, 2):
        assert off == {}
        # a step: each train BN's [mean, mean²] forward and its cotangent
        # backward (2·C float32 each), the loss's normaliser (one float32)
        # and the flat gradient with the four loss terms
        assert on["trainer.collectives"] == 2 * (2 * n_bn + 2)
        assert on["trainer.collective_bytes"] == 2 * (2 * 2 * channels * 4 + 4
                                                      + (n_params + 4) * 4)
        assert "trainer.graph_pool_bytes" not in on


@pytest.mark.cuda
def test_the_captured_step_counts_its_pool():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    from dcfa_yolo_tpu_torch.train.trainer import WARMUP_STEPS

    tr = _trainer("cuda")
    b = _batch(tr)
    for _ in range(WARMUP_STEPS + 1):  # the third step captures
        tr.train_step(b, 1e-2)
    off, on = _counted(tr, b, 2)
    assert tr.graph_stats()["captures"] == 1
    assert off == {}
    assert set(on) == {"trainer.graph_pool_bytes"} and on["trainer.graph_pool_bytes"] > 0
    assert on["trainer.graph_pool_bytes"] == tr._graph.pool_bytes


# -- the readers -------------------------------------------------------------
def _trace(ops, steps):
    """ops: (name, start µs, dur µs); `steps` train_step ranges."""
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d,
           "args": {"correlation": i}} for i, (n, ts, d) in enumerate(ops)]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "train_step", "ts": 1000.0 * s,
            "dur": 900.0} for s in range(steps)]
    return Trace(ev, steps * 1e-3, steps, labels=("train_step",))


def test_allreduce_ms_takes_each_collective_on_its_last_rank():
    # 2 steps, 3 collectives on 2 ranks: rank 0 waits in the first
    # (300 µs against rank 1's 100), rank 1 in the others: 100 + 50 + 80
    # µs on the link, 0.115 ms a step
    tr = _trace([("ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)", 100, 300),
                 ("elementwise_kernel", 250, 500)], 2)
    per_rank = [[300.0, 50.0, 80.0], [100.0, 400.0, 90.0]]
    assert links.allreduce_ms({"trace": tr, "nccl_us": per_rank}) == pytest.approx(0.115)
    assert links.allreduce_ms({"trace": tr, "nccl_us": [[300.0], [100.0, 1.0]]}) is None
    assert links.allreduce_ms({"trace": tr, "nccl_us": [[], []]}) is None
    assert links.allreduce_ms({"trace": tr}) is None


def test_the_driver_lists_nccl_kernels_in_launch_order():
    from drivers.train_dp import nccl_durations

    tr = _trace([("ncclDevKernel_AllReduce", 500, 7), ("elementwise_kernel", 1, 1),
                 ("ncclKernel_AllReduce_RING", 20, 3)], 1)
    assert nccl_durations(tr) == [3.0, 7.0]


def test_allreduce_roofline(monkeypatch):
    # 2 steps of 30 MB a step over 4 ranks: 45 MB of bus bytes a step,
    # 0.1 ms on the link, against 0.2 ms of NCCL kernels on the last rank:
    # 50%
    bus = links.ring_bus_bytes(30e6, 4)
    assert bus == pytest.approx(45e6)
    t_us = 2 * bus / links.NVLINK4_BYTES_PER_S * 1e6
    tr = _trace([("ncclDevKernel_AllReduce", 10, t_us)], 2)
    ctx = {"trace": tr, "world": 4, "nccl_us": [[t_us, 3 * t_us]] + [[5 * t_us, t_us]] * 3}
    monkeypatch.setattr(links, "program_counters",
                        lambda: {"trainer.collective_bytes": 60e6})
    assert links.allreduce_roofline(ctx) == pytest.approx(50.0)
    assert links.allreduce_roofline(dict(ctx, world=1)) is None
    monkeypatch.setattr(links, "program_counters", lambda: None)
    assert links.allreduce_roofline(ctx) is None


def test_graph_pool_gib(monkeypatch):
    monkeypatch.setattr(links, "program_counters",
                        lambda: {"trainer.graph_pool_bytes": 3 * 2**30})
    assert links.graph_pool_gib({}) == pytest.approx(3.0)
    monkeypatch.setattr(links, "program_counters", lambda: {})
    assert links.graph_pool_gib({}) is None
    monkeypatch.setattr(links, "program_counters", lambda: None)
    assert links.graph_pool_gib({}) is None


def test_the_graph_pool_reading_is_taken():
    from dcfa_yolo_tpu_torch.utils import profiling

    profiling.clear_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("trainer.graph_pool_bytes", 2**30, total=True)
        profiling.count("trainer.collectives", 3)
    assert links.graph_pool_gib({}) == pytest.approx(1.0)
    assert links.graph_pool_gib({}) is None  # a later run reads its own pool
    assert profiling.counters() == {"trainer.collectives": 3}
    profiling.clear_counters()


@pytest.mark.parametrize("world,cores,want", [
    (4, list(range(32)), [[0, 1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13, 14, 15],
                          [16, 17, 18, 19, 20, 21, 22, 23], [24, 25, 26, 27, 28, 29, 30, 31]]),
    (2, [0, 1, 2], [[0], [1]]),
    (3, [5], [[5], [5], [5]]),
])
def test_each_rank_takes_cores_of_its_own(world, cores, want):
    from benchlib import ranks

    assert [ranks.cores_of(r, world, cores) for r in range(world)] == want
