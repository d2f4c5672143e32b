"""The link yardstick of the data-parallel cell: the peak of the link
between the cards, the bytes a ring all-reduce moves over it, and the
readers of the program's collective and graph-pool counters
(`dcfa_yolo_tpu_torch.utils.profiling.count`).

The peak is NVIDIA's H100 SXM data sheet: NVLink 4, 18 links of 25 GB/s
each way, 450 GB/s each way a card (`nvidia-smi nvlink -s` lists 18 links
at 26.562 GB/s on the four-card machine).  A ring all-reduce of n bytes
over W ranks sends and receives 2·(W−1)/W · n bytes on each card's link
(the bus bytes of NCCL's own tests): its least time is that over the
peak.
"""

from __future__ import annotations

from typing import Dict, Optional

NVLINK4_BYTES_PER_S = 450e9  # each way, a card


def ring_bus_bytes(nbytes: float, world: int) -> float:
    """Bytes each card's link carries each way in a ring all-reduce of
    `nbytes` over `world` ranks."""
    return 2.0 * (world - 1) / world * nbytes


def allreduce_bound_s(nbytes: float, world: int) -> float:
    """Least seconds of a ring all-reduce of `nbytes` over `world` ranks."""
    return ring_bus_bytes(nbytes, world) / NVLINK4_BYTES_PER_S


def program_counters() -> Optional[Dict[str, float]]:
    """The program's counters, or None where the program has none."""
    try:
        from dcfa_yolo_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters()


def allreduce_ms(ctx: Dict) -> Optional[float]:
    """Device ms a step that the traced window's all-reduces take on the
    link: for each collective, the shortest of its NCCL kernel's times on
    the ranks (`nccl_us`: each rank's kernel µs in launch order), over the
    `train_step` ranges of rank 0's trace.  A rank's kernel runs from its
    own arrival to the collective's end, so it also holds the wait for the
    ranks that come later; the last rank to arrive waits for none, and its
    time, the shortest, is the transfer and NCCL's own latency.  None
    without every rank's kernels, or where the ranks' counts differ."""
    tr, per_rank = ctx.get("trace"), ctx.get("nccl_us")
    if tr is None or not tr.count("train_step") or not per_rank or not per_rank[0]:
        return None
    if any(len(d) != len(per_rank[0]) for d in per_rank):
        return None
    return sum(min(col) for col in zip(*per_rank)) / 1e3 / tr.count("train_step")


def allreduce_roofline(ctx: Dict) -> Optional[float]:
    """The all-reduces' least time a step on the link (the bytes the
    program counted, `trainer.collective_bytes`, as a ring over the cell's
    ranks) over `allreduce_ms`, per cent."""
    ms = allreduce_ms(ctx)
    c = program_counters() or {}
    world = ctx.get("world")
    if not ms or not c.get("trainer.collective_bytes") or not world or world < 2:
        return None
    per_step = c["trainer.collective_bytes"] / ctx["trace"].count("train_step")
    return 100.0 * allreduce_bound_s(per_step, world) / (ms / 1e3)


def graph_pool_gib(ctx: Dict) -> Optional[float]:
    """GiB the captured step's private memory pool holds
    (`trainer.graph_pool_bytes`); None without a captured step.  The
    reading is taken: the counter is dropped, so that a later run in the
    same process reports only its own pool."""
    v = (program_counters() or {}).get("trainer.graph_pool_bytes")
    try:
        from dcfa_yolo_tpu_torch.utils.profiling import clear_counters

        clear_counters("trainer.graph_pool_bytes")
    except ImportError:  # a program without counters
        pass
    return v / 2**30 if v else None
