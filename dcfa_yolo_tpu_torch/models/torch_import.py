"""The reference's weights → the port's state_dict: the port's counterpart of
`dcfa_yolo_tpu/models/torch_import.py`.

The reference's key space (`nets/yolo_mul.py`, `nets/repghost.py`) maps
key by key onto the port's.  The port's modules are named after the JAX
package's flax scopes (`models/convert.py`), so the map is the JAX
importer's composed with `convert.py`'s leaf renames: a conv's `kernel` is
`weight` here, a BN's `scale / mean / var` are `weight / running_mean /
running_var`, which are the reference's own leaf names.  Conv weights stay
OIHW, the layout the reference and the port share.

The single-modal → dual-modal surgery of `train_mul.py:143-171` applies:
a `backbone.*` key loads into both `backbone_rgb` and `backbone_nir`.  The
frozen DFL conv (`dfl.*`, weights arange(16), `nets/yolo_mul.py:312-322`)
is a function here, and `num_batches_tracked` has no counterpart: both are
skipped.
"""

from __future__ import annotations

import pickle
import re
import zipfile
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

_BN = ("weight", "bias", "running_mean", "running_var")

# the ShuffleNet unit's Sequential indices → the port's module names
_SHUFFLE_IDX = {
    "branch1.0": "b1_dwconv", "branch1.1": "b1_bn1",
    "branch1.2": "b1_conv2", "branch1.3": "b1_bn2",
    "branch2.0": "b2_conv1", "branch2.1": "b2_bn1",
    "branch2.3": "b2_dwconv", "branch2.4": "b2_bn2",
    "branch2.5": "b2_conv3", "branch2.6": "b2_bn3",
}
_SHORTCUT_IDX = {"0": ("sc_dwconv", "conv"), "1": ("sc_bn1", "bn"),
                 "2": ("sc_conv", "conv"), "3": ("sc_bn2", "bn")}


def _bn(name: str, leaf: str) -> Optional[str]:
    return f"{name}.{leaf}" if leaf in _BN else None


def _cbam(rest: str) -> Optional[str]:
    """CBAM: `channelattention.fc1/fc2.weight`, `spatialattention.conv1.weight`."""
    if re.fullmatch(r"channelattention\.(fc1|fc2)\.weight|spatialattention\.conv1\.weight",
                    rest):
        return rest
    return None


def _convbn(rest: str, name: str) -> Optional[str]:
    """The reference's `Conv` block: `<name>.conv.weight`, `<name>.bn.*`."""
    if rest == "conv.weight":
        return f"{name}.conv.weight"
    m = re.fullmatch(r"bn\.(\w+)", rest)
    return _bn(f"{name}.bn", m.group(1)) if m else None


def _ghost_module(rest: str) -> Optional[str]:
    """RepGhostModule (`nets/repghost.py:70-115`)."""
    if rest == "primary_conv.0.weight":
        return "primary_conv.weight"
    m = re.fullmatch(r"(primary_conv\.1|fusion_bn\.0|cheap_operation\.1)\.(\w+)", rest)
    if m:
        name = {"primary_conv.1": "primary_bn", "fusion_bn.0": "fusion_bn",
                "cheap_operation.1": "cheap_bn"}[m.group(1)]
        return _bn(name, m.group(2))
    # cheap_operation.0 in the train graph; a bare biased conv in a deploy
    # checkpoint
    m = re.fullmatch(r"cheap_operation\.(?:0\.)?(weight|bias)", rest)
    return f"cheap_conv.{m.group(1)}" if m else None


def _bottleneck(rest: str) -> Optional[str]:
    """RepGhostBottleneck (`nets/repghost.py:178-279`)."""
    m = re.fullmatch(r"(ghost1|ghost2)\.(.+)", rest)
    if m:
        sub = _ghost_module(m.group(2))
        return f"{m.group(1)}.{sub}" if sub else None
    if rest == "conv_dw.weight":
        return rest
    m = re.fullmatch(r"bn_dw\.(\w+)", rest)
    if m:
        return _bn("bn_dw", m.group(1))
    if re.fullmatch(r"se\.(conv_reduce|conv_expand)\.(weight|bias)", rest):
        return rest
    m = re.fullmatch(r"shortcut\.(\d)\.(\w+)", rest)
    if m and m.group(1) in _SHORTCUT_IDX:
        name, kind = _SHORTCUT_IDX[m.group(1)]
        if kind == "conv":
            return f"{name}.weight" if m.group(2) == "weight" else None
        return _bn(name, m.group(2))
    return None


def _c2f(rest: str) -> Optional[str]:
    """C2f_repghost (`nets/repghost.py:308-320`)."""
    m = re.fullmatch(r"(cv1|cv2)\.(.+)", rest)
    if m:
        return _convbn(m.group(2), m.group(1))
    m = re.fullmatch(r"m\.(\d+)\.(.+)", rest)
    if m:
        sub = _bottleneck(m.group(2))
        return f"m{m.group(1)}.{sub}" if sub else None
    return None


def _backbone(rest: str) -> Optional[str]:
    """Backbone (`nets/yolo_mul.py:252-308`)."""
    if rest == "stem.conv.0.weight":
        return "stem.conv.weight"
    m = re.fullmatch(r"stem\.conv\.1\.(\w+)", rest)
    if m:
        return _bn("stem.bn", m.group(1))
    m = re.fullmatch(r"(dark[2-5])\.0\.(.+)", rest)
    if m:
        return _convbn(m.group(2), f"{m.group(1)}_conv")
    m = re.fullmatch(r"(dark[2-5])\.1\.(branch[12]\.\d)\.(\w+)", rest)
    if m and m.group(2) in _SHUFFLE_IDX:
        name = f"{m.group(1)}_shuffle.{_SHUFFLE_IDX[m.group(2)]}"
        leaf = m.group(3)
        if name.endswith(("dwconv", "conv1", "conv2", "conv3")):
            return f"{name}.{leaf}" if leaf in ("weight", "bias") else None
        return _bn(name, leaf)
    m = re.fullmatch(r"dark5\.2\.(cv1|cv2)\.(.+)", rest)
    if m:
        sub = _convbn(m.group(2), m.group(1))
        return f"dark5_sppf.{sub}" if sub else None
    m = re.fullmatch(r"dark5\.2\.(cbam[1-4])\.(.+)", rest)
    if m:
        sub = _cbam(m.group(2))
        return f"dark5_sppf.{m.group(1)}.{sub}" if sub else None
    return None


def reference_key_to_port(key: str) -> Optional[str]:
    """The port's state_dict key for one key of the reference's state_dict;
    None for a key to skip (`num_batches_tracked`, `dfl.*`, anything the
    JAX importer does not map)."""
    if key.endswith("num_batches_tracked") or key.startswith("dfl."):
        return None
    rules = ((r"(backbone_rgb|backbone_nir)\.(.+)", _backbone),
             (r"(cbam_(?:rgb|nir)_feat[123])\.(.+)", _cbam),
             (r"(conv3_for_(?:up|down)sample[12])\.(.+)", _c2f))
    for pattern, fn in rules:
        m = re.fullmatch(pattern, key)
        if m:
            sub = fn(m.group(2))
            return f"{m.group(1)}.{sub}" if sub else None
    if key == "bi_fpn.w":
        return key
    m = re.fullmatch(r"(down_sample[12])\.(.+)", key)
    if m:
        return _convbn(m.group(2), m.group(1))
    m = re.fullmatch(r"(cv[23])\.(\d)\.([01])\.(.+)", key)
    if m:
        return _convbn(m.group(4), f"{m.group(1)}_{m.group(2)}_{m.group(3)}")
    m = re.fullmatch(r"(cv[23])\.(\d)\.2\.(weight|bias)", key)
    if m:
        return f"{m.group(1)}_{m.group(2)}_2.{m.group(3)}"
    return None


def import_state_dict(state_dict: Mapping[str, np.ndarray],
                      template_state_dict: Mapping[str, torch.Tensor],
                      duplicate_single_backbone: bool = True,
                      strict: bool = False
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    """Fill a copy of the port's `template_state_dict` from the reference's
    `state_dict` (numpy arrays), as float32 CPU tensors.

    duplicate_single_backbone: the `train_mul.py:150-159` surgery, a
    `backbone.*` key loads into both modal branches.  Returns (state_dict,
    report); the report lists the reference keys matched and skipped, and
    the port keys missing (left as in the template).  A shape mismatch
    raises; strict=True also raises if a port key was not filled.
    """
    filled = dict(template_state_dict)
    hit = set()
    matched, skipped = [], []
    expanded: Dict[str, np.ndarray] = {}
    for k, v in state_dict.items():
        if duplicate_single_backbone and k.startswith("backbone."):
            rest = k[len("backbone."):]
            expanded[f"backbone_rgb.{rest}"] = v
            expanded[f"backbone_nir.{rest}"] = v
        else:
            expanded[k] = v
    for k, v in expanded.items():
        dest = reference_key_to_port(k)
        if dest is None or dest not in template_state_dict:
            skipped.append(k)
            continue
        value = torch.as_tensor(np.asarray(v, dtype=np.float32))
        want = tuple(template_state_dict[dest].shape)
        if tuple(value.shape) != want:
            raise ValueError(f"shape mismatch: reference {k} {tuple(value.shape)} vs "
                             f"port {dest} {want}")
        filled[dest] = value
        hit.add(dest)
        matched.append(k)
    missing = [k for k in template_state_dict if k not in hit]
    if strict and missing:
        raise ValueError(f"{len(missing)} port state_dict entries not filled, "
                         f"e.g. {missing[:5]}")
    return filled, {"matched": matched, "skipped": skipped, "missing": missing}


def is_npz(path: str) -> bool:
    """Whether `path` is a zip whose members are all `.npy` files (`np.savez`);
    `torch.save` zips hold `data.pkl` and raw storages."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
    return bool(names) and all(n.endswith(".npy") for n in names)


def torch_load_weights(path: str):
    """`torch.load(path, weights_only=True)` on the CPU.  A file that only
    loads by running pickle code raises: the port does not run it."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path} holds objects that only load by running pickle "
                         f"code (torch.load(weights_only=False)); the port loads "
                         f"weights with weights_only=True and does not run it") from e


def state_dict_arrays(obj) -> Optional[Dict[str, np.ndarray]]:
    """A loaded `.pth` as {key: numpy array}, its top-level `state_dict`
    entry unwrapped (`torch_import.py:296-299`); None unless that is a
    non-empty flat mapping of tensors."""
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not (isinstance(obj, dict) and obj
            and all(isinstance(v, torch.Tensor) for v in obj.values())):
        return None
    return {k: (v.detach().cpu().float() if v.is_floating_point()
                else v.detach().cpu()).numpy() for k, v in obj.items()}


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """The reference's state_dict from a `.npz` (numpy) or a `.pth`
    (`torch_load_weights`), told apart by content, as {key: numpy array}."""
    if is_npz(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = state_dict_arrays(torch_load_weights(path))
    if sd is None:
        raise ValueError(f"{path} is not a state_dict (a mapping of names to tensors)")
    return sd
