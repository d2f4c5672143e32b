"""The traced window: `torch.profiler` over a number of calls, each inside
a host range the benchmark names (`detect`, `augment`, `train_step`), and
the reduction of its device trace.

The trace is exported as Chrome JSON into a directory under TMPDIR, read
back and deleted.  Device operations are the `kernel`, `gpu_memcpy` and
`gpu_memset` events; each is tied to the host call that launched it by its
`correlation` id, and that launch to the benchmark's host range that
encloses it.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """What the per-layer readers take from a traced window."""

    def __init__(self, events: List[dict], window_s: float, n_calls: int,
                 labels: Sequence[str]):
        self.window_s = window_s
        self.n_calls = n_calls
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.device_ops = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
                            (e.get("args") or {}).get("correlation")) for e in dev]
        self.ranges = sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                             for e in events
                             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                             and e.get("name") in labels)
        launches = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = float(e["ts"])
        self.launch_ts = launches
        self.cpu_ops = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                               e["name"], e.get("tid"))
                              for e in events
                              if e.get("ph") == "X" and e.get("cat") == "cpu_op")
        self._cpu_starts = [op[0] for op in self.cpu_ops]
        self.t_lo = min((r[1] for r in self.ranges), default=0.0)
        self.t_hi = max((r[2] for r in self.ranges), default=0.0)

    # -- device time ---------------------------------------------------
    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals (µs), merged."""
        iv = sorted((ts, ts + dur) for _, ts, dur, _ in self.device_ops)
        out: List[List[float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_us(self, pattern: str) -> List[float]:
        """Durations (µs) of the device operations whose name holds
        `pattern`."""
        return [dur for name, _, dur, _ in self.device_ops if pattern in name]

    def range_of(self, t: float) -> Optional[str]:
        for name, a, b in self.ranges:
            if a <= t <= b:
                return name
        return None

    def ops_in(self, label: str) -> List[Tuple[str, float, float, object]]:
        """Device operations launched from inside a host range `label`."""
        spans = [(a, b) for name, a, b in self.ranges if name == label]
        out = []
        for op in self.device_ops:
            t = self.launch_ts.get(op[3])
            if t is not None and any(a <= t <= b for a, b in spans):
                out.append(op)
        return out

    def count(self, label: str) -> int:
        return sum(1 for name, _, _ in self.ranges if name == label)

    # -- breakdown -----------------------------------------------------
    def top_device_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for name, _, dur, _ in self.device_ops:
            tot[name[:120]] += dur / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def _host_op_at(self, t: float) -> str:
        """The latest-started host operator still running at t."""
        i = bisect.bisect_right(self._cpu_starts, t) - 1
        for j in range(i, max(i - 4000, -1), -1):
            a, b, name, _ = self.cpu_ops[j]
            if b >= t:
                return name
        return "python"

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle device time inside the traced window, summed by what the
        host was doing when each gap began: its range and innermost
        operator."""
        busy = self.busy_intervals()
        gaps = []
        prev = self.t_lo
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t_hi > prev:
            gaps.append((prev, self.t_hi))
        tot: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            label = f"{self.range_of(a) or 'between calls'}:{self._host_op_at(a)}"
            tot[label[:120]] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def record(call: Callable[[int], None], n: int, label: str,
           device: torch.device) -> Trace:
    """Trace `n` calls of `call(i)`, each in a host range `label`, and
    reduce the trace.  The window runs from the synchronise before the
    first call to the synchronise after the last."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function("window"):
            for i in range(n):
                with record_function(label):
                    call(i)
            sync()
        window_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="bench_trace")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tr = Trace(events, window_s, n, labels=(label, "detect", "augment", "train_step", "window"))
    # the window's own range bounds the idle gaps
    win = [r for r in tr.ranges if r[0] == "window"]
    if win:
        tr.t_lo, tr.t_hi = win[0][1], win[0][2]
    tr.ranges = [r for r in tr.ranges if r[0] != "window"]
    return tr
