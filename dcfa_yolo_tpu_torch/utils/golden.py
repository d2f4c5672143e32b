"""Deterministic synthetic weights and inputs for parity checks: the port's
copy of `dcfa_yolo_tpu/utils/golden.py`, in numpy.

The reference repo ships no weights, so parity with the reference PyTorch
model is checked on synthesized state_dicts: every tensor is filled from a
numpy generator seeded by (global seed, key name), so both sides make the
same values from the committed key/shape manifest
(`tests/goldens/manifest.json`).  `tests/goldens/model_fwd.npz` holds the
reference model's outputs on these weights and inputs; `golden_errors`
holds a port model against them.
"""

from __future__ import annotations

import json
import zlib
from typing import Dict, List, Sequence

import numpy as np
import torch


def _rng_for(key: str, seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(seed * 1_000_003 + zlib.crc32(key.encode())))


def synth_value(key: str, shape: Sequence[int], seed: int = 0) -> np.ndarray:
    """Deterministic value for one state_dict entry: conv weights
    N(0, 0.05), BN scale N(1, 0.1), biases N(0, 0.05), running means
    N(0, 0.2), running vars U(0.5, 1.5), BiFPN weights U(0.5, 1.5)."""
    rng = _rng_for(key, seed)
    shape = tuple(int(s) for s in shape)
    if key.endswith("running_var"):
        return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
    if key.endswith("running_mean"):
        return (rng.standard_normal(shape) * 0.2).astype(np.float32)
    if key.endswith("num_batches_tracked"):
        return np.zeros(shape, dtype=np.int64)
    if key == "bi_fpn.w":
        return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
    if len(shape) == 1:
        if key.endswith("weight"):  # BN gamma
            return (1.0 + rng.standard_normal(shape) * 0.1).astype(np.float32)
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)  # biases
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)  # conv kernels


def synth_state_dict(manifest: Dict[str, List[int]], seed: int = 0) -> Dict[str, np.ndarray]:
    """The reference's state_dict with every entry from `synth_value`."""
    return {k: synth_value(k, shape, seed) for k, shape in manifest.items()}


def synth_input(name: str, shape: Sequence[int], seed: int = 0) -> np.ndarray:
    """Deterministic input tensor in [0, 1) (images are /255-normalized)."""
    rng = _rng_for("input:" + name, seed)
    return rng.uniform(0.0, 1.0, size=tuple(int(s) for s in shape)).astype(np.float32)


def load_manifest(path: str) -> Dict[str, List[int]]:
    """The reference's state_dict keys and shapes (`tests/goldens/manifest.json`)."""
    with open(path) as f:
        return json.load(f)


# (rtol, atol) of tests/test_model_parity.py: both sides float32, summed in
# other orders; the taps are stored as float16
GOLDEN_TOL = {"tap": (5e-2, 5e-3), "feat": (1e-3, 2e-4), "dbox": (1e-3, 5e-4),
              "cls": (1e-3, 2e-4)}
# (module, tap name in model_fwd.npz, index into the module's output)
_TAPS = (("conv3_for_upsample1", "neck_p4_up1", None),
         ("conv3_for_upsample2", "neck_p3", None),
         ("conv3_for_downsample1", "neck_p4_down", None),
         ("conv3_for_downsample2", "neck_p5", None),
         ("backbone_rgb", "backbone_rgb_feat1", 0),
         ("backbone_rgb", "backbone_rgb_feat2", 1),
         ("backbone_nir", "backbone_nir_feat1", 0))


def golden_errors(model, goldens: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The eval forward of a phi='n' 640² train-graph `model` (a
    `models/yolo.py::DCFAYolo` on any device, float32) on `synth_input`'s
    rgb and nir pair, against the reference's outputs `goldens`
    (`tests/goldens/model_fwd.npz`): for the seven taps, the three head
    maps, `dbox` and `cls`, the largest |mine − ref| / (atol + rtol·|ref|)
    at `GOLDEN_TOL`.  Each is at most 1 where numpy's `assert_allclose`
    passes."""
    taps: Dict[str, np.ndarray] = {}
    hooks = []
    for mod, name, idx in _TAPS:
        def hook(_mod, _inp, out, name=name, idx=idx):
            taps[name] = (out if idx is None else out[idx]).float().cpu().numpy()
        hooks.append(getattr(model, mod).register_forward_hook(hook))
    dev = next(model.parameters()).device
    x = [torch.from_numpy(np.ascontiguousarray(
        synth_input(n, (1, 3, 640, 640)).transpose(0, 2, 3, 1))).to(dev)
        for n in ("rgb", "nir")]
    try:
        with torch.inference_mode():
            out = model(*x)
    finally:
        for h in hooks:
            h.remove()

    def err(mine, ref, kind):
        rtol, atol = GOLDEN_TOL[kind]
        ref = ref.astype(np.float32)
        return float((np.abs(mine - ref) / (atol + rtol * np.abs(ref))).max())

    errors = {name: err(taps[name], goldens[f"tap_{name}"], "tap") for _, name, _ in _TAPS}
    for level, key in enumerate(("feat_p3", "feat_p4", "feat_p5")):
        errors[key] = err(out.feats[level].float().cpu().numpy(),
                          goldens[key].transpose(0, 2, 3, 1), "feat")
    for key in ("dbox", "cls"):
        errors[key] = err(getattr(out, key).float().cpu().numpy(),
                          goldens[key].transpose(0, 2, 1), key)
    return errors
