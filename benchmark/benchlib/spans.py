"""The program's own spans (`dcfa_yolo_tpu_torch.utils.profiling.span`) in
a traced window, moved onto the device trace's clock, and what each holds.

The program records a span's start and end on `time.perf_counter_ns`'s
clock; the trace (`benchlib.trace.Trace`) is on the profiler's.  One
constant offset moves the first onto the second, bounded by what each
span must hold.  Each benchmark range (`Trace.ranges`: `detect`,
`augment`, `train_step`) starts before the root span it encloses, so the
offset is at least the range's start less the root span's start: the
largest such difference is the lower bound, loose by the least Python
between a range's start and its root span's.  Each `pipeline.replay` span
starts before it launches its graph, whose kernels name the launch by
correlation id, so the offset is at most the launch's time less the
replay's start: the smallest is the upper bound, loose by the least Python
from a replay's start to its launch, one call.  The offset is the upper
bound where the window holds replays, the lower bound where it does not
(training, whose metrics are host times, which no offset moves); the
residual is the distance between the two bounds.

For each span name, per request (per root span of its kind: a call, a
step, a batch): host ms, host self ms (less what its child spans cover),
device ms (the union of the intervals of the device operations whose
launch, by correlation id, falls inside the span, on any thread) and
device-idle ms inside the span.  A program without spans, or
a window in which it recorded none, reads None.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

# how far a root span, moved by a candidate offset, may stick out of the
# benchmark range that encloses it (µs): the Python between the range's
# start and the span's, which an epoch's first batch lengthens
SLACK_US = 1000.0


def recorded() -> Optional[list]:
    """The process's span records, or None where the program has no spans."""
    try:
        from dcfa_yolo_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return None
    return recorded_spans()


def merge(iv) -> List[Tuple[float, float]]:
    """Intervals sorted and merged where they overlap or touch."""
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(merged: Sequence[Tuple[float, float]], a: float, b: float) -> float:
    """How much of [a, b] the merged intervals cover."""
    i = max(bisect.bisect_right(merged, (a, float("inf"))) - 1, 0)
    tot = 0.0
    while i < len(merged) and merged[i][0] < b:
        lo, hi = max(merged[i][0], a), min(merged[i][1], b)
        if hi > lo:
            tot += hi - lo
        i += 1
    return tot


def _leaves(ranges) -> List[Tuple[float, float]]:
    """The benchmark's ranges that hold no other range, by start.  Ranges
    nest (each thread's ranges form a stack), so one that holds any range
    holds the next to start."""
    iv = sorted(((a, b) for _, a, b in ranges), key=lambda r: (r[0], -r[1]))
    return [(a, b) for k, (a, b) in enumerate(iv)
            if k + 1 == len(iv) or iv[k + 1][0] >= b]


def range_bounds(ranges, roots) -> List[float]:
    """Each enclosed root's difference (µs), its range's start less its own,
    from the benchmark's ranges and the root spans [(start µs, end µs)] on
    the program's clock; each is a lower bound of the offset.

    The newest root span belongs to the traced window (older ones may be
    another window's).  Each range that could hold it gives a candidate
    offset; the candidate under which the most root spans fall inside a
    range wins (the latest range on a tie).  Under it, each enclosed root
    gives the difference of its range's start and its own start."""
    leaves = _leaves(ranges)
    if not leaves or not roots:
        return []
    starts = [a for a, _ in leaves]

    def host(s, e, d):
        # the range holding the root's middle: a range that starts right
        # after a short root would give a bound past the offset
        j = bisect.bisect_right(starts, (s + e) / 2 + d) - 1
        if j >= 0 and leaves[j][0] - SLACK_US <= s + d and e + d <= leaves[j][1] + SLACK_US:
            return j
        return None

    s_last, e_last = max(roots, key=lambda r: r[1])
    best = None
    for a, b in leaves:
        if e_last - s_last > b - a + SLACK_US:
            continue
        d = a - s_last
        n = sum(host(s, e, d) is not None for s, e in roots)
        if best is None or n >= best[0]:
            best = (n, d)
    if best is None or best[0] == 0:
        return []
    diffs = []
    for s, e in roots:
        j = host(s, e, best[1])
        if j is not None:
            diffs.append(leaves[j][0] - s)
    return diffs


def launch_bounds(trace, replays, lower: float) -> List[float]:
    """Each replay's difference (µs), its graph launch's time less its own
    start, from the replay spans [(start µs, end µs)] on the program's
    clock; each is an upper bound of the offset.  A replay's launch is the
    one, within `SLACK_US` after its start moved by the lower bound, whose
    correlation id the most device operations carry (a graph's kernels all
    carry their launch's)."""
    ops = Counter(op[3] for op in trace.device_ops if op[3] is not None)
    launches = sorted((t, c) for c, t in trace.launch_ts.items() if ops[c] > 1)
    starts = [t for t, _ in launches]
    diffs = []
    for s, _ in replays:
        i = bisect.bisect_left(starts, s + lower)
        j = bisect.bisect_right(starts, s + lower + SLACK_US)
        if i < j:
            t, _ = max(launches[i:j], key=lambda x: ops[x[1]])
            diffs.append(t - s)
    return diffs


class SpanView:
    """The spans of one traced window on the trace's clock (µs)."""

    def __init__(self, trace, records):
        self.trace = trace
        recs = [(i, n, s / 1e3, e / 1e3, p, q) for i, n, s, e, p, q in records]
        lows = range_bounds(trace.ranges, [(s, e) for _, _, s, e, p, _ in recs if p is None])
        self.spans: List[tuple] = []
        if not lows:
            return
        lower = max(lows)
        highs = launch_bounds(trace, [(s, e) for _, n, s, e, _, _ in recs
                                      if n == "pipeline.replay"], lower)
        self.anchors = (len(lows), len(highs))
        self.offset_us, self.residual_us = lower, None  # µs
        if highs:
            self.offset_us = min(highs)
            self.residual_us = self.offset_us - lower
        lo, hi = trace.t_lo, trace.t_hi
        moved = [(i, n, s + self.offset_us, e + self.offset_us, p, q)
                 for i, n, s, e, p, q in recs]
        self.spans = [sp for sp in moved if sp[3] >= lo and sp[2] <= hi]
        self.by_id = {sp[0]: sp for sp in self.spans}
        self.children: Dict[int, List[tuple]] = defaultdict(list)
        for sp in self.spans:
            if sp[4] is not None:
                self.children[sp[4]].append(sp)
        self.busy = trace.busy_intervals()
        # device operations by the time their launch was made
        ops = sorted((trace.launch_ts[op[3]], op[1], op[1] + op[2])
                     for op in trace.device_ops if op[3] in trace.launch_ts)
        self._launch_t = [o[0] for o in ops]
        self._ops = ops

    # -- one span -------------------------------------------------------
    def root(self, sp) -> tuple:
        while sp[4] is not None and sp[4] in self.by_id:
            sp = self.by_id[sp[4]]
        return sp

    def of(self, name: str) -> List[tuple]:
        return [sp for sp in self.spans if sp[1] == name]

    def host_us(self, sp) -> float:
        return sp[3] - sp[2]

    def self_us(self, sp) -> float:
        kids = merge((c[2], c[3]) for c in self.children.get(sp[0], ()))
        return sp[3] - sp[2] - covered(kids, sp[2], sp[3])

    def launched(self, sp) -> List[Tuple[float, float]]:
        """Device intervals of the operations launched inside the span."""
        i = bisect.bisect_left(self._launch_t, sp[2])
        j = bisect.bisect_right(self._launch_t, sp[3])
        return [(a, b) for _, a, b in self._ops[i:j]]

    def device_us(self, sp) -> float:
        return sum(b - a for a, b in merge(self.launched(sp)))

    def idle_us(self, sp) -> float:
        return sp[3] - sp[2] - covered(self.busy, sp[2], sp[3])

    # -- a name ---------------------------------------------------------
    def per_request_ms(self, name: str, measure) -> Optional[float]:
        """`measure` (µs of one span) summed over the name's spans, over
        the count of root spans of their kind, in ms; None where the name
        has no span."""
        spans = self.of(name)
        if not spans:
            return None
        kind = self.root(spans[0])[1]
        n_roots = sum(1 for sp in self.spans if sp[4] is None and sp[1] == kind)
        return sum(measure(sp) for sp in spans) / 1e3 / max(n_roots, 1)

    def replay_device_ms(self) -> Optional[float]:
        """Device ms a call launched from `pipeline.replay`: the operations
        tied by correlation id to a launch inside it, a graph's kernels to
        their `cudaGraphLaunch`; None where no operation is."""
        replays = self.of("pipeline.replay")
        if not any(self.launched(sp) for sp in replays):
            return None
        return self.per_request_ms("pipeline.replay", self.device_us)

    def idle_split(self) -> Dict[str, float]:
        """Idle device µs of the window inside root spans and outside any."""
        lo, hi = self.trace.t_lo, self.trace.t_hi
        idle = (hi - lo) - covered(self.busy, lo, hi)
        roots = merge((max(sp[2], lo), min(sp[3], hi)) for sp in self.spans
                      if sp[4] is None and sp[3] > lo and sp[2] < hi)
        inside = sum(b - a - covered(self.busy, a, b) for a, b in roots)
        return {"window": idle, "inside": inside, "outside": idle - inside}


def view(ctx) -> Optional[SpanView]:
    """The context's trace with the program's spans, built once a run and
    kept in the context; None without a trace, without spans, or where
    none falls in the window."""
    if "spans" not in ctx:
        tr, records = ctx.get("trace"), recorded()
        ctx["spans"] = SpanView(tr, records) if tr is not None and records else None
    v = ctx["spans"]
    return v if v is not None and v.spans else None


# -- the readers (`benchmark/metrics/<name>.py`) ---------------------------
def _host(name: str):
    def read(ctx) -> Optional[float]:
        v = view(ctx)
        if v is None:
            return None
        return v.per_request_ms(name, v.host_us)
    return read


def _idle(name: str):
    def read(ctx) -> Optional[float]:
        v = view(ctx)
        if v is None or not v.trace.device_ops:
            return None
        return v.per_request_ms(name, v.idle_us)
    return read


def replay_device_ms(ctx) -> Optional[float]:
    """Device ms a call launched from `pipeline.replay`."""
    v = view(ctx)
    if v is None or not v.trace.device_ops:
        return None
    return v.replay_device_ms()


copy_in_idle_ms = _idle("pipeline.copy_in")
copy_out_idle_ms = _idle("predictor.copy_out")
augment_host_ms = _host("device_aug.batch")
