"""Faults planted under the timed path, to show that `correct` catches
them.  Each is a context manager that patches the program while it is
entered; the tests and `benchmark/calibrate.py` use them, a benchmark run
never does.

Serving (the pipeline's result, where the predictor receives it):
- `alter`: the first image's first detection moved by 2% of the image's
  longer side (an answer altered where it is produced);
- `half_batch`: the detections of the second half of the batch dropped
  (half of the batch left out).

Training (`Trainer`):
- `half_batch`: the loss and its gradient taken over the first half of
  the batch (the mean over the rest);
- `unchanged`: the optimizer and EMA update skipped (a step that returns
  its state unchanged).

On one chip there is no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch

SERVE = ("alter", "half_batch")
TRAIN = ("half_batch", "unchanged")


def applicable(cell):
    """The faults the cell can have: no half batch to leave out at b1."""
    if cell.traffic["driver"] == "serve":
        return SERVE if int(cell.traffic["batch"]) > 1 else ("alter",)
    return TRAIN


def _patch(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    return lambda: setattr(module, name, old)


def _served(fault: str, res, image_side: float):
    boxes, valid = res.boxes.clone(), res.valid.clone()
    if fault == "alter" and bool(valid[0, 0]):
        boxes[0, 0] += 0.02 * image_side
    if fault == "half_batch":
        b = valid.shape[0]
        valid[b - b // 2:] = False
        boxes[b - b // 2:] = 0.0
    return res._replace(boxes=boxes, valid=valid)


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """Plant `fault` of the driver kind `kind` ('serve' or 'train')."""
    undo = []
    if kind == "serve":
        from dcfa_yolo_tpu_torch.infer import predictor

        for name in ("detect_batch_graph", "detect_batch"):
            def make(old):
                def run(model, rgb, nir, image_hw, **kw):
                    res = old(model, rgb, nir, image_hw, **kw)
                    return _served(fault, res, float(torch.as_tensor(image_hw).max()))
                return run
            undo.append(_patch(predictor, name, make))
    elif fault == "half_batch":
        from dcfa_yolo_tpu_torch.train.trainer import Batch, Trainer

        def make(old):
            def loss(self, feats, batch):
                h = batch.rgb.shape[0] // 2
                return old(self, tuple(f[:h] for f in feats), Batch(*(t[:h] for t in batch)))
            return loss
        undo.append(_patch(Trainer, "loss", make))
    elif fault == "unchanged":
        from dcfa_yolo_tpu_torch.train.trainer import Trainer

        undo.append(_patch(Trainer, "update", lambda old: lambda self, *a, **k: None))
    else:
        raise ValueError(f"no fault {fault!r} for {kind}")
    try:
        yield
    finally:
        for u in undo:
            u()
