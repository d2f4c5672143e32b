"""Timing utilities of the port (`dcfa_yolo_tpu/utils/profiling.py`): the
H100's peaks and the bound they give, a device timer, the bench's
steady-state timer, the training CLI's `StepTimer` and `trace`."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

# NVIDIA H100 SXM data sheet, at its 700 W power limit
H100_BYTES_PER_S = 3.35e12  # HBM3
H100_BF16_FLOPS = 989e12    # dense tensor-core bf16
H100_FP32_FLOPS = 67e12     # CUDA-core float32


def bound(nbytes: float, ops: float, peak: float) -> Tuple[float, str]:
    """Least time on the H100, in ms, for work that moves `nbytes` and does
    `ops` operations at `peak` per second: the larger of the two times,
    and which one it is ("bytes" or "operations")."""
    t_b, t_o = nbytes / H100_BYTES_PER_S, ops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


@contextlib.contextmanager
def trace(log_dir: Optional[str], device="cuda") -> Iterator[None]:
    """Record a `torch.profiler` trace (CPU, and CUDA on a CUDA device) of
    the block into `log_dir/trace.json` (a no-op when log_dir is empty).
    The block's device work is waited for before the trace ends."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield
        finally:
            _sync(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Mean and percentiles of step times.  On a CUDA device `start` and
    `stop` record CUDA events on the current stream and never wait: a
    sample is the stream's time from one event to the other, read in
    `summary` after one synchronise, so the host goes on feeding the card
    while it works.  On the CPU a sample is the host clock around the
    step."""

    def __init__(self, device="cuda") -> None:
        self.cuda = torch.device(device).type == "cuda"
        self.samples: List[float] = []
        self._events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._t0 = None

    def start(self) -> None:
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is None:
            return
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append((self._t0, end))
        else:
            self.samples.append(time.perf_counter() - self._t0)
        self._t0 = None

    def summary(self) -> Dict[str, float]:
        if self._events:
            self._events[-1][1].synchronize()
            self.samples += [a.elapsed_time(b) / 1e3 for a, b in self._events]
            self._events = []
        if not self.samples:
            return {}
        xs = sorted(self.samples)
        n = len(xs)
        return {
            "mean_ms": 1000 * sum(xs) / n,
            "p50_ms": 1000 * xs[n // 2],
            "p95_ms": 1000 * xs[min(n - 1, int(n * 0.95))],
            "steps": n,
        }


def _sync(device) -> None:
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(fn, iters: int, device="cuda", warmup: int = 2) -> float:
    """Mean time of one call of `fn()` after `warmup` calls: CUDA events
    around `iters` back-to-back calls on a CUDA device, the host clock on
    the CPU."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def timeit_chained(fn, args, *, iters: int = 50, trials: int = 3,
                   warmup: int = 8, subtract_fixed: bool = False,
                   device="cuda") -> float:
    """Median seconds per call of `fn(*args)` in a back-to-back burst.

    The JAX version chains each call's input to the previous call's output
    by a zero scalar, so that the device cannot overlap calls.  On CUDA the
    calls already run one after another in the order of the stream they
    are issued on, so no chain is needed: each burst issues `iters` calls
    and ends in one `torch.cuda.synchronize()` (none for `device` "cpu"),
    and the host clock around it covers the device work.

    subtract_fixed=True times each trial at `iters` and at `3*iters` calls
    and returns the slope (T3 − T1) / (2·iters): the steady-state time per
    call, without the fixed cost of one burst (its final synchronise).
    """
    for _ in range(warmup + 1):
        fn(*args)
    _sync(device)

    def burst(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        _sync(device)
        return time.perf_counter() - t0

    times = []
    for _ in range(trials):
        if subtract_fixed:
            t1 = burst(iters)
            t3 = burst(3 * iters)
            times.append((t3 - t1) / (2 * iters))
        else:
            times.append(burst(iters) / iters)
    return sorted(times)[len(times) // 2]


def forward_flops(model, batch: int = 1) -> int:
    """FLOPs of one eval forward of a `DCFAYolo` at its `cfg.input_shape`,
    through its own stem graph, counted by `torch.utils.flop_counter`:
    convolutions and matrix products at 2 FLOPs per multiply-add, and no
    elementwise, pooling or reduction ops (XLA's cost analysis, which the
    JAX package reports, counts those too)."""
    from torch.utils.flop_counter import FlopCounterMode

    h, w = model.cfg.input_shape
    x = torch.zeros(batch, h, w, 3, device=next(model.parameters()).device)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model(x, x)
    return counter.get_total_flops()
