"""Checkpoint save and load of the port (`dcfa_yolo_tpu/utils/checkpoint.py`).

A checkpoint bundles what exact resume needs, under the JAX payload's keys:
`params` and `batch_stats` (state_dict names → tensors), `ema` (the EMA of
every floating state entry), `opt_state` (`Optimizer.state()`),
`ema_updates` and `epoch`.  It is one `torch.save` file of tensors, dicts
and numbers, written to `<path>.tmp` and then renamed, and it loads with
`torch.load(..., weights_only=True)`.  Checkpoints always hold the
canonical (unfolded) train graph's names and layouts.
"""

from __future__ import annotations

import os
import pickle
import zipfile
from typing import Any, Dict

import torch

KEYS = ("params", "batch_stats", "ema", "opt_state", "ema_updates", "epoch")
_FOREIGN = ("{path} is not a checkpoint of the PyTorch port (a torch.save "
            "file with the keys {keys}). Loading the JAX package's msgpack "
            ".ckpt files and the reference's .pth weights is not ported yet "
            "(ROADMAP.md, queue 1, item 12).")


def _to_cpu(node):
    if isinstance(node, torch.Tensor):
        return node.detach().cpu()
    if isinstance(node, dict):
        return {k: _to_cpu(v) for k, v in node.items()}
    return node


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Write `payload` (the KEYS) to `path` atomically."""
    missing = [k for k in KEYS if k not in payload]
    if missing:
        raise KeyError(f"checkpoint payload lacks {missing}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_cpu(payload), tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint written by `save_checkpoint` (tensors on the CPU);
    anything else raises."""
    if not zipfile.is_zipfile(path):
        raise ValueError(_FOREIGN.format(path=path, keys=KEYS))
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except (RuntimeError, pickle.UnpicklingError) as e:  # a zip, not torch's (.npz)
        raise ValueError(_FOREIGN.format(path=path, keys=KEYS)) from e
    if not isinstance(ckpt, dict) or any(k not in ckpt for k in KEYS):
        raise ValueError(_FOREIGN.format(path=path, keys=KEYS))
    return ckpt


def load_variables(path: str) -> Dict[str, torch.Tensor]:
    """The train graph's state_dict from a checkpoint, preferring the EMA
    weights (`checkpoint.py:68-72`): what evaluation and serving load."""
    ckpt = load_checkpoint(path)
    if ckpt["ema"]:
        return dict(ckpt["ema"])
    return {**ckpt["params"], **ckpt["batch_stats"]}
