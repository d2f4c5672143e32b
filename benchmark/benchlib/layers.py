"""The per-layer readers' arithmetic.  Each `benchmark/metrics/<name>.py`
names one of these as its `read`; each takes the run's layer context (the
trace, the rates and counts of the untraced window, the cell) and returns
a number, or None where the trace holds nothing to read."""

from __future__ import annotations

from typing import Dict, Optional

from benchlib import yardstick


def _mean_s(durations_us) -> Optional[float]:
    return sum(durations_us) / len(durations_us) / 1e6 if durations_us else None


def idle_share(ctx: Dict) -> Optional[float]:
    """Per cent of the traced window in which no kernel, copy or set ran
    on the device (the union of their intervals)."""
    tr = ctx.get("trace")
    if tr is None or not tr.device_ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def mfu(ctx: Dict) -> Optional[float]:
    """Per cent of the bf16 peak: the FLOPs an item needs (a pair's
    forward, or an image's forward and backward) times the items a second
    of the untraced window completed."""
    if not ctx.get("flops_per_item") or not ctx.get("rate_items_per_s"):
        return None
    return 100.0 * ctx["flops_per_item"] * ctx["rate_items_per_s"] / yardstick.BF16_FLOPS


def stem_eval_roofline(ctx: Dict) -> Optional[float]:
    """Kernel A's bound over its mean device time a launch, per cent."""
    tr = ctx.get("trace")
    t = _mean_s(tr.kernel_us("stem_eval_kernel")) if tr else None
    if not t:
        return None
    nbytes, flops = yardstick.stem_eval_work(ctx["batch"], ctx["input_hw"])
    return 100.0 * yardstick.bound_s(nbytes, flops, yardstick.BF16_FLOPS) / t


def nms_suppress_roofline(ctx: Dict) -> Optional[float]:
    """Kernel B's bound (bytes, and the IoU pairs the greedy pass needs)
    over its device time a call (mask and scan), per cent."""
    tr = ctx.get("trace")
    if tr is None or "nms_pairs_per_call" not in ctx:
        return None
    us = tr.kernel_us("nms_mask_kernel") + tr.kernel_us("nms_scan_kernel")
    if not us:
        return None
    t = sum(us) / 1e6 / tr.n_calls
    nbytes, ops = yardstick.nms_work(ctx["batch"], ctx["k"], ctx["nms_pairs_per_call"])
    return 100.0 * yardstick.bound_s(nbytes, ops, yardstick.FP32_FLOPS) / t


def stem_train_roofline(ctx: Dict) -> Optional[float]:
    """Kernel C's bound (bf16) over its mean device time a launch, per
    cent."""
    tr = ctx.get("trace")
    t = _mean_s(tr.kernel_us("stem_train_kernel")) if tr else None
    if not t:
        return None
    nbytes, flops = yardstick.stem_train_work(ctx["batch"], ctx["input_hw"], 2)
    return 100.0 * yardstick.bound_s(nbytes, flops, yardstick.BF16_FLOPS) / t


def augment_ms(ctx: Dict) -> Optional[float]:
    """Device ms a batch of the operations launched inside `augment`."""
    tr = ctx.get("trace")
    if tr is None or not tr.count("augment"):
        return None
    ops = tr.ops_in("augment")
    if not ops:
        return None
    return sum(op[2] for op in ops) / 1e3 / tr.count("augment")


def launches_per_step(ctx: Dict) -> Optional[float]:
    """Device kernels, copies and sets launched inside `train_step`, a
    step."""
    tr = ctx.get("trace")
    if tr is None or not tr.count("train_step"):
        return None
    ops = tr.ops_in("train_step")
    return len(ops) / tr.count("train_step") if ops else None
