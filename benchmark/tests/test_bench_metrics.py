"""The yardstick's arithmetic: the roofline bounds of kernels A, B and C
against the counts PERF.md's kernel table gives, the FLOP count against
the port's own, and the per-layer readers on a hand-made trace."""

from __future__ import annotations

import numpy as np
import pytest
from benchlib import layers, yardstick
from benchlib.trace import Trace
from reference.model import Sizes


def _ms(nbytes, ops, peak):
    return yardstick.bound_s(nbytes, ops, peak) * 1e3


@pytest.mark.parametrize("batch,bound_ms", [(1, 0.00172), (8, 0.01373), (4, 0.00687)])
def test_kernel_a_bound(batch, bound_ms):
    nbytes, flops = yardstick.stem_eval_work(batch, (640, 640))
    assert _ms(nbytes, flops, yardstick.BF16_FLOPS) == pytest.approx(bound_ms, rel=3e-3)


def test_kernel_a_is_bound_by_bytes():
    nbytes, flops = yardstick.stem_eval_work(1, (640, 640))
    assert nbytes / yardstick.HBM_BYTES_PER_S > flops / yardstick.BF16_FLOPS


@pytest.mark.parametrize("elem,mbytes,bound_ms", [(2, 144.2, 0.04304), (4, 288.4, 0.08608)])
def test_kernel_c_bound(elem, mbytes, bound_ms):
    nbytes, flops = yardstick.stem_train_work(16, (640, 640), elem)
    assert nbytes / 1e6 == pytest.approx(mbytes, rel=1e-3)
    peak = yardstick.BF16_FLOPS if elem == 2 else yardstick.FP32_FLOPS
    assert _ms(nbytes, flops, peak) == pytest.approx(bound_ms, rel=3e-3)
    assert flops / 1e9 == pytest.approx(5.66, rel=1e-3)


def test_kernel_b_bound_from_pairs():
    # PERF.md's served b8, K = 1024: 278,501 IoU pairs needed, bound by operations
    nbytes, ops = yardstick.nms_work(8, 1024, 278_501)
    assert _ms(nbytes, ops, yardstick.FP32_FLOPS) == pytest.approx(0.0000499, rel=3e-3)


def test_nms_pairs_counts_what_the_greedy_pass_needs():
    # three boxes: 0 suppresses 1, then 0 is compared with 1 and 2, and 2 with none
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]], np.float32)
    assert yardstick.nms_pairs(boxes, np.ones(3, bool), 0.5) == 2
    # apart, every pair is needed: 2 + 1
    boxes[1] = [20, 20, 30, 30]
    assert yardstick.nms_pairs(boxes, np.ones(3, bool), 0.5) == 3
    # dead candidates cost nothing
    assert yardstick.nms_pairs(boxes, np.array([True, False, False]), 0.5) == 0


@pytest.mark.parametrize("phi", ["n", "s"])
def test_forward_flops_matches_the_ports_count(phi):
    from dcfa_yolo_tpu_torch.config import ModelConfig
    from dcfa_yolo_tpu_torch.models.yolo import init_model
    from dcfa_yolo_tpu_torch.utils.profiling import forward_flops

    port = init_model(ModelConfig(phi=phi, input_shape=(64, 64)), 0, "cpu",
                      deploy=True, fold_shuffle=True)
    assert yardstick.forward_flops(Sizes(phi, 1, 16, (64, 64)), 1) == forward_flops(port, 1)


def test_train_flops_are_about_three_forwards():
    sizes = Sizes("n", 1, 16, (640, 640))
    fwd = yardstick.forward_flops(sizes, 2)
    both = yardstick.forward_flops(sizes, 2, train=True)
    assert 2.5 * fwd < both < 3.3 * fwd
    # about 7.5 GFLOP a pair at 640² (PERF.md: bench's MFU at b128)
    assert 5e9 < fwd / 2 < 10e9


def _trace(ops, ranges, window_s=1e-3, n_calls=1):
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d,
           "args": {"correlation": c}} for n, ts, d, c in ops]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t,
            "dur": 1, "args": {"correlation": c}} for c, t in
           {c: ts - 5 for _, ts, _, c in ops}.items()]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
           for n, a, b in ranges]
    tr = Trace(ev, window_s, n_calls, labels=("detect", "augment", "train_step"))
    tr.t_lo, tr.t_hi = 0.0, window_s * 1e6
    return tr


def test_idle_share_is_one_less_the_union_of_device_intervals():
    # two overlapping kernels (100-300, 200-400) and one apart (600-700):
    # 400 µs busy of 1000
    tr = _trace([("a", 100, 200, 1), ("b", 200, 200, 2), ("c", 600, 100, 3)],
                [("detect", 0, 1000)])
    assert tr.busy_s() == pytest.approx(400e-6)
    assert layers.idle_share({"trace": tr}) == pytest.approx(60.0)


def test_readers_return_none_where_nothing_is_traced():
    tr = _trace([("other", 10, 5, 1)], [("detect", 0, 100)])
    ctx = {"trace": tr, "batch": 1, "input_hw": (640, 640), "k": 1024,
           "nms_pairs_per_call": 10}
    assert layers.stem_eval_roofline(ctx) is None
    assert layers.nms_suppress_roofline(ctx) is None
    assert layers.stem_train_roofline(ctx) is None
    assert layers.augment_ms(ctx) is None
    assert layers.launches_per_step(ctx) is None
    assert layers.mfu({}) is None


def test_roofline_share_and_range_attribution():
    # kernel A at 2x its bound: 50%
    nbytes, flops = yardstick.stem_eval_work(1, (640, 640))
    t_us = 2 * yardstick.bound_s(nbytes, flops, yardstick.BF16_FLOPS) * 1e6
    tr = _trace([("void stem_eval_kernel(...)", 100, t_us, 1),
                 ("aug_k", 300, 40, 2), ("step_k", 600, 10, 3), ("step_k", 700, 10, 4)],
                [("augment", 200, 400), ("train_step", 500, 900)])
    ctx = {"trace": tr, "batch": 1, "input_hw": (640, 640)}
    assert layers.stem_eval_roofline(ctx) == pytest.approx(50.0)
    assert layers.augment_ms(ctx) == pytest.approx(0.040)
    assert layers.launches_per_step(ctx) == 2
    assert layers.mfu({"flops_per_item": 989e9, "rate_items_per_s": 10}) == pytest.approx(1.0)
