"""Serving weight transforms on the port's `state_dict`
(`dcfa_yolo_tpu/models/reparam.py`): RepGhost fusion for the deploy graph,
the channel-shuffle fold, and the pre-cast of conv kernels.

Each function maps a state_dict (name → tensor) to a new one and leaves its
input unchanged.  Load the result into the graph it was made for:
`DCFAYolo(cfg, deploy=True)` after `deploy_state_dict`,
`DCFAYolo(cfg, fold_shuffle=True)` after `fold_shuffle_state_dict`
(`models/yolo.py::init_model` does both).

RepGhost math (per module, depthwise kernels OIHW (C, 1, 3, 3), float32):
    fused_kernel = K_dw·g_c/σ_c + pad_1x1→3x3(I·g_f/σ_f)
    fused_bias   = (β_c − μ_c·g_c/σ_c) + (β_f − μ_f·g_f/σ_f)
where (g, β, μ, σ²) are the cheap-BN (c) and fusion-BN (f) parameters and
statistics, σ = √(σ² + 1e-5).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]
Spec = List[Tuple[str, int, np.ndarray]]

_BN_EPS = 1e-5  # RepGhost BNs use the torch default (`nets/repghost.py:100`)
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _fuse_bn(kernel: torch.Tensor, bn: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a BN into an OIHW kernel along its output channels
    (`reparam.py:26-30`)."""
    t = bn["weight"] / torch.sqrt(bn["running_var"] + _BN_EPS)
    return kernel * t.view(-1, 1, 1, 1), bn["bias"] - bn["running_mean"] * t


def _identity_dw_kernel_3x3(c: int, device: torch.device) -> torch.Tensor:
    """Depthwise identity as a 3x3 kernel (centre tap 1), OIHW (C, 1, 3, 3)."""
    k = torch.zeros(c, 1, 3, 3, device=device)
    k[:, 0, 1, 1] = 1.0
    return k


def deploy_state_dict(sd: StateDict) -> StateDict:
    """Train-graph state_dict → deploy-graph state_dict (`deploy_variables`,
    `reparam.py:241-257`): every RepGhost module's `cheap_bn` and
    `fusion_bn` fold into a biased depthwise `cheap_conv`, in float32;
    everything else is unchanged."""
    out = dict(sd)
    for key in sd:
        if not key.endswith(".cheap_bn.weight"):
            continue
        prefix = key[:-len("cheap_bn.weight")]
        bns = {}
        for name in ("cheap_bn", "fusion_bn"):
            bns[name] = {leaf: out.pop(f"{prefix}{name}.{leaf}").float()
                         for leaf in _BN_LEAVES}
        k_dw = sd[prefix + "cheap_conv.weight"].float()
        kernel, bias = _fuse_bn(k_dw, bns["cheap_bn"])
        k2, b2 = _fuse_bn(_identity_dw_kernel_3x3(k_dw.shape[0], k_dw.device),
                          bns["fusion_bn"])
        out[prefix + "cheap_conv.weight"] = kernel + k2
        out[prefix + "cheap_conv.bias"] = bias + b2
    return out


def _shuffle_inv_perm(c: int) -> np.ndarray:
    """Inverse of `channel_shuffle(·, groups=2)` as an index array
    (`reparam.py:82-93`): shuffle emits y[j] = z[(j % 2)·c/2 + j//2], so a
    consumer of y that reads the unshuffled z takes its input rows at
    inv[i] = 2i (i < c/2), else 2(i − c/2) + 1."""
    half = c // 2
    inv = np.empty(c, np.int64)
    inv[:half] = 2 * np.arange(half)
    inv[half:] = 2 * np.arange(half) + 1
    return inv


def shuffle_fold_spec(sd: StateDict) -> Spec:
    """The fold as data (`reparam.py:96-137`): [(key, axis, rows)] with
    fold = index_select(sd[key], axis, rows).  Kernels are OIHW, so a
    consumer's input-channel rows are axis 1 and the CBAM fc2's output rows
    axis 0.  The consumers of a shuffled map: dark{3,4,5}_conv and
    dark5_sppf.cv1 in each backbone, the feat1/feat2 CBAMs' channel MLP, and
    the feat segments of the neck's conv3_for_upsample{1,2}.cv1 inputs
    ((p_up, feat_rgb, feat_nir), `nets/yolo_mul.py:428-443`)."""
    spec = []
    for bk in ("backbone_rgb", "backbone_nir"):
        for consumer in ("dark3_conv", "dark4_conv", "dark5_conv", "dark5_sppf.cv1"):
            key = f"{bk}.{consumer}.conv.weight"
            spec.append((key, 1, _shuffle_inv_perm(sd[key].shape[1])))
    for tap in ("feat1", "feat2"):
        for mod in ("rgb", "nir"):
            ca = f"cbam_{mod}_{tap}.channelattention"
            inv = _shuffle_inv_perm(sd[f"{ca}.fc1.weight"].shape[1])
            spec.append((f"{ca}.fc1.weight", 1, inv))
            spec.append((f"{ca}.fc2.weight", 0, inv))
    for neck, feat_src in (("conv3_for_upsample2", "dark4_conv"),
                           ("conv3_for_upsample1", "dark5_conv")):
        featc = sd[f"backbone_rgb.{feat_src}.conv.weight"].shape[1]
        key = f"{neck}.cv1.conv.weight"
        pc = sd[key].shape[1] - 2 * featc
        inv = _shuffle_inv_perm(featc)
        spec.append((key, 1, np.concatenate([np.arange(pc), pc + inv,
                                             pc + featc + inv])))
    return spec


def apply_shuffle_spec(sd: StateDict, spec: Spec, inverse: bool = False
                       ) -> StateDict:
    """Apply (or invert, taking rows at argsort(rows)) a `shuffle_fold_spec`
    (`reparam.py:146-160`)."""
    out = dict(sd)
    for key, axis, rows in spec:
        idx = np.argsort(rows) if inverse else rows
        out[key] = torch.index_select(out[key], axis,
                                      torch.as_tensor(idx, device=out[key].device))
    return out


def fold_opt_state(opt_state: Dict, spec: Spec, inverse: bool = False) -> Dict:
    """Fold (or unfold) an optimizer state with a `shuffle_fold_spec`
    (`reparam.py:216-238`): every dict keyed by parameter name (SGD's
    `trace`, Adam's `mu` and `nu`) is permuted like the parameters; scalars
    (Adam's `count`) pass through.  The update is elementwise and the clip's
    global norm permutation-invariant, so training folded with folded
    moments is the unfolded trajectory, permuted."""
    return {k: apply_shuffle_spec(v, spec, inverse) if isinstance(v, dict) else v
            for k, v in opt_state.items()}


def fold_shuffle_state_dict(sd: StateDict) -> StateDict:
    """Absorb the backbones' channel shuffles into the consumers' weights
    (`fold_shuffle_variables`, `reparam.py:163-194`), for
    `DCFAYolo(cfg, fold_shuffle=True)`.  BN parameters and statistics are
    untouched: every permuted row is an input row of a consumer whose BN
    normalizes its own output channels.  Works on train-graph or deploy
    state_dicts; exact up to the conv's input-channel summation order."""
    return apply_shuffle_spec(sd, shuffle_fold_spec(sd))


def unfold_shuffle_state_dict(sd: StateDict) -> StateDict:
    """Exact inverse of `fold_shuffle_state_dict` (a permutation)."""
    return apply_shuffle_spec(sd, shuffle_fold_spec(sd), inverse=True)


def cast_conv_kernels(sd: StateDict, dtype: torch.dtype = torch.bfloat16
                      ) -> StateDict:
    """Pre-cast every 4-D conv kernel to the serving compute dtype
    (`reparam.py:260-292`).  Each conv casts its kernel to the activation
    dtype when it runs (`ops/conv.py::Conv`), so in that dtype the output is
    bit-identical.  BN leaves and biases stay float32: the eval-BN fold reads
    them in float32.  Apply after the deploy and fold transforms, and load
    with `load_state_dict(..., assign=True)` so the dtype is kept."""
    return {k: (v.to(dtype) if v.dim() == 4 else v) for k, v in sd.items()}


def cast_model_conv_kernels(model: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """`cast_conv_kernels` on a model's own weights, in place (loaded with
    `assign=True`, which keeps the new dtype); returns the model."""
    model.load_state_dict(cast_conv_kernels(model.state_dict(), dtype), strict=True,
                          assign=True)
    return model
