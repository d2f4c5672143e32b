"""The port's state_dict → the reference's full state_dict key space: the
port's counterpart of `dcfa_yolo_tpu/models/torch_export.py`, the inverse
of `models/torch_import.py`.

Lets models trained by the port load into the reference implementation
(`nets/yolo_mul.py`).  Conv weights are OIHW on both sides; the frozen DFL
projection is synthesized (arange, `nets/yolo_mul.py:316-317`) and every
`num_batches_tracked` is 0.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from dcfa_yolo_tpu_torch.models.torch_import import reference_key_to_port
from dcfa_yolo_tpu_torch.utils.golden import load_manifest

MANIFEST = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "goldens", "manifest.json")


def export_state_dict(state_dict: Mapping[str, torch.Tensor], num_classes: int = 1,
                      reg_max: int = 16) -> Dict[str, np.ndarray]:
    """The reference's full state_dict, float32 numpy (int64 counters),
    from the port's train-graph `state_dict`.

    The key space is the golden manifest's (made by instantiating the
    reference model, `tools/gen_goldens.py`), mapped through the importer.
    The manifest covers phi='n', the reference's only working phi; a
    state_dict with entries outside that key space raises instead of
    being dropped, and so does a head whose class count is not
    `num_classes`.
    """
    if not os.path.exists(MANIFEST):
        raise FileNotFoundError(
            f"{MANIFEST} not found: export needs the reference key-space "
            "manifest (regenerate with tools/gen_goldens.py)")
    out: Dict[str, np.ndarray] = {}
    consumed = set()
    for ref_key in load_manifest(MANIFEST):
        if ref_key.endswith("num_batches_tracked"):
            out[ref_key] = np.asarray(0, dtype=np.int64)
            continue
        if ref_key == "dfl.conv.weight":
            out[ref_key] = np.arange(reg_max, dtype=np.float32).reshape(1, reg_max, 1, 1)
            continue
        key = reference_key_to_port(ref_key)
        if key is None:
            raise KeyError(f"no mapping for reference key {ref_key}")
        consumed.add(key)
        # cast before numpy: a bf16 entry must not reach np.savez raw; copy:
        # the export must not alias a live parameter
        out[ref_key] = state_dict[key].detach().to("cpu", torch.float32).numpy().copy()
    # completeness: every entry must land in the reference key space, else
    # the export would be a silently partial checkpoint (the extra RepGhost
    # bottlenecks of phi='s'/'m' have no phi='n' keys)
    leftover = [k for k in state_dict if k not in consumed]
    if leftover:
        raise ValueError(
            f"{len(leftover)} state_dict entries have no reference key in the "
            f"manifest (first: {leftover[:3]}): this config's key space is not the "
            "reference phi='n' space")
    ncls = out["cv3.0.2.weight"].shape[0]
    if ncls != num_classes:
        raise ValueError(f"model head has {ncls} classes, caller claimed {num_classes}")
    return out


def save_torch_npz(path: str, state_dict: Mapping[str, torch.Tensor],
                   num_classes: int = 1) -> None:
    """Save the reference's state_dict as a `.npz`, which
    `torch_import.load_torch_checkpoint` and torch users (through numpy)
    load."""
    np.savez_compressed(path, **export_state_dict(state_dict, num_classes))
