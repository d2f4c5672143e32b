"""Weights carrier: the JAX package's flax variables → the port's state_dict.

The port's submodules are named after the flax scopes
(`backbone_rgb.dark2_shuffle.b2_conv1`, `cbam_rgb_feat1`, `bi_fpn`,
`cv2_0_0`, …), so the carrier is a flatten of the tree plus two renames:
conv kernels HWIO → OIHW under `weight`, and the BN leaves
`scale/bias/mean/var` → `weight/bias/running_mean/running_var`.  The tree
arrives as nested mappings of numpy arrays; no JAX is imported.
`unflatten` rebuilds that tree from flat `/`-joined keys, the layout of
the trained-weights fixture `tests/fixtures/ab_weights_f16.npz`.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var", "w": "w"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    """Flat `/`-joined flax keys (`params/backbone_rgb/stem/conv/kernel`) →
    the nested `{"params", "batch_stats"}` tree (the port's copy of
    `tools/make_ab_fixture.py::unflatten`)."""
    tree: Dict = {}
    for key, v in flat.items():
        *scopes, leaf = key.split("/")
        node = tree
        for p in scopes:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def load_flat_npz(path: str) -> Dict:
    """A `.npz` of flat flax keys (`unflatten`) as a float32 variables tree,
    ready for `from_jax_variables`."""
    with np.load(path) as z:
        return unflatten({k: z[k].astype(np.float32) for k in z.files})


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax `{"params", "batch_stats"}` tree → port state_dict (float32,
    CPU).  Load it with `model.load_state_dict(sd, strict=True)`."""
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, v in _flatten(variables.get(coll, {})):
            leaf = path[-1]
            if leaf not in _LEAF:
                raise ValueError(f"unknown flax leaf {'/'.join(path)}")
            if leaf == "kernel" and v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)  # HWIO → OIHW
            key = ".".join(path[:-1] + (_LEAF[leaf],))
            sd[key] = torch.from_numpy(np.ascontiguousarray(v))
    return sd
