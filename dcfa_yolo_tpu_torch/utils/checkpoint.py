"""Checkpoint save and load of the port (`dcfa_yolo_tpu/utils/checkpoint.py`).

A checkpoint bundles what exact resume needs, under the JAX payload's keys:
`params` and `batch_stats` (state_dict names → tensors), `ema` (the EMA of
every floating state entry), `opt_state` (`Optimizer.state()`),
`ema_updates` and `epoch`.  It is one `torch.save` file of tensors, dicts
and numbers, written to `<path>.tmp` and then renamed, and it loads with
`torch.load(..., weights_only=True)`.  Checkpoints always hold the
canonical (unfolded) train graph's names and layouts.

`load_variables` reads weights from four formats, told apart by content,
not by name: the port's checkpoint, the reference's state_dict as a `.pth`
(torch's zip or its older pickle format) or a `.npz`
(`models/torch_import.py`), and the JAX package's msgpack `.ckpt` (decoded
here, without flax).
"""

from __future__ import annotations

import os
import zipfile
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from dcfa_yolo_tpu_torch.models.convert import from_jax_variables
from dcfa_yolo_tpu_torch.models.torch_import import (import_state_dict, is_npz,
                                                     load_torch_checkpoint,
                                                     state_dict_arrays,
                                                     torch_load_weights)

KEYS = ("params", "batch_stats", "ema", "opt_state", "ema_updates", "epoch")
FORMATS = (f"a checkpoint of the PyTorch port (a torch.save file with the keys "
           f"{KEYS})", "the reference's state_dict as a torch.save .pth",
           "the reference's state_dict as a numpy .npz",
           "the JAX package's msgpack .ckpt")
_UNKNOWN = "{path} is none of the weight formats the port reads: " + "; ".join(FORMATS)
_NOT_RESUMABLE = ("{path} is not a checkpoint of the PyTorch port (a torch.save file "
                  "with the keys {keys}), the only format that resumes training. As "
                  "weights, load_variables (model_path, --model-path) reads it if it "
                  "is one of: " + "; ".join(FORMATS[1:]))
# the start of a `torch.save` file in torch's pre-zip format
# (`_use_new_zipfile_serialization=False`): pickle protocol 2 and torch's
# magic number; msgpack cannot start so (0x80 alone is an empty map)
_LEGACY_TORCH = b"\x80\x02\x8a\x0a\x6c\xfc\x9c\x46\xf9\x20\x6a\xa8\x50\x19"


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


def _is_torch_file(path: str) -> bool:
    """Whether `path` is a `torch.save` file: a zip, or torch's pre-zip
    pickle format."""
    if zipfile.is_zipfile(path):
        return True
    with open(path, "rb") as f:
        return f.read(len(_LEGACY_TORCH)) == _LEGACY_TORCH


def _torch_load(path: str):
    """`torch.load(weights_only=True)` of a torch file (`torch_load_weights`);
    None for a zip that is not torch's."""
    try:
        return torch_load_weights(path)
    except RuntimeError:  # a zip, not torch's
        return None


def _is_port_checkpoint(obj) -> bool:
    return isinstance(obj, dict) and all(k in obj for k in KEYS)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint written by `save_checkpoint` (tensors on the CPU),
    what `--resume` takes; any other file raises."""
    ckpt = _torch_load(path) if _is_torch_file(path) else None
    if not _is_port_checkpoint(ckpt):
        raise ValueError(_NOT_RESUMABLE.format(path=path, keys=KEYS))
    return ckpt


# --- the JAX package's msgpack checkpoint --------------------------------------

def _ext(code: int, data: bytes):
    """flax's ndarray ext type (1): msgpack of (shape, dtype name, C-order
    bytes).  The JAX `save_checkpoint` writes every leaf as one."""
    import msgpack

    if code != 1:
        return msgpack.ExtType(code, data)
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    # a copy: frombuffer's arrays are read-only
    return np.frombuffer(buf, np.dtype(dtype.decode())).reshape(shape).copy()


def decode_msgpack(blob: bytes):
    """The tree a flax `msgpack_serialize` wrote, as `msgpack_restore`
    reads it for the JAX package's checkpoints (leaves under flax's 1 GiB
    chunk size), with numpy arrays as leaves and lists as dicts keyed "0",
    "1", … (flax's `to_state_dict` form).  Raises ValueError on bytes that
    are not one msgpack object."""
    import msgpack

    try:
        return msgpack.unpackb(blob, ext_hook=_ext, raw=False,
                               list_hook=lambda x: {str(i): v for i, v in enumerate(x)})
    except (ValueError, TypeError) as e:  # msgpack's errors are ValueErrors
        raise ValueError(str(e)) from e


# --- any of the four formats ---------------------------------------------------

def read_weights(path: str):
    """(format, content) of a weight file, by content: ('port', checkpoint
    dict), ('reference', {key: numpy array}) or ('jax', msgpack tree).
    Any other file raises, naming the four formats."""
    if is_npz(path):
        return "reference", load_torch_checkpoint(path)
    if _is_torch_file(path):
        obj = _torch_load(path)
        if _is_port_checkpoint(obj):
            return "port", obj
        sd = state_dict_arrays(obj)
        if sd is None:
            raise ValueError(_UNKNOWN.format(path=path))
        return "reference", sd
    with open(path, "rb") as f:
        blob = f.read()
    try:
        tree = decode_msgpack(blob)
    except ValueError as e:
        raise ValueError(_UNKNOWN.format(path=path)) from e
    if not (isinstance(tree, dict) and isinstance(tree.get("params"), dict)):
        raise ValueError(_UNKNOWN.format(path=path))
    return "jax", tree


def load_variables(path: str,
                   template: Optional[Callable[[], Mapping[str, torch.Tensor]]] = None
                   ) -> Dict[str, torch.Tensor]:
    """The train graph's state_dict (CPU tensors) from a weight file in any
    of the four formats (`read_weights`), the JAX `load_variables`:
      * the port's checkpoint: the EMA weights first (`checkpoint.py:68-72`),
        else params and batch_stats;
      * the JAX package's `.ckpt`: the same choice, as the JAX
        `load_variables` makes it, carried by `convert.from_jax_variables`;
      * the reference's `.pth` / `.npz`: imported over `template()` (the
        train graph's state_dict of the right phi and class count, made only
        here) by `torch_import.import_state_dict`, a single-modal file into
        both backbones, entries it lacks left at the template's.  A file
        none of whose keys is the model's raises.
    """
    kind, content = read_weights(path)
    if kind == "port":
        if content["ema"]:
            return dict(content["ema"])
        return {**content["params"], **content["batch_stats"]}
    if kind == "jax":
        if content.get("ema"):
            return from_jax_variables({
                "params": content["ema"]["params"],
                "batch_stats": content["ema"].get("batch_stats",
                                                  content.get("batch_stats", {}))})
        return from_jax_variables({"params": content["params"],
                                   "batch_stats": content.get("batch_stats", {})})
    if template is None:
        raise ValueError(f"{path} holds the reference's state_dict: importing it needs "
                         f"the model's state_dict as a template")
    sd, report = import_state_dict(content, template())
    if not report["matched"]:
        raise ValueError(f"{path}: none of its {len(content)} keys is a key of the "
                         f"reference model (e.g. {list(content)[:3]})")
    return sd
