"""The paired serving graph of the port (`dcfa_yolo_tpu/models/pairing.py`):
both backbones as ONE doubled-channel stream.

The reference runs two backbones of one architecture side by side
(`nets/yolo_mul.py:342-343,399-400`).  Pairing is a weight transform plus
a paired module graph, exact up to floating-point summation order:

  * every dense conv of the two backbones becomes one conv on the
    concatenated stream with a block-diagonal kernel (the off-modality
    blocks are zeros, and a zero addend is exact);
  * depthwise convs, BN leaves and biases concatenate per channel;
  * every paired tensor is an "alternating modality block" layout
    [R_blk0 | N_blk0 | R_blk1 | N_blk1 | ...] of equal blocks, described by
    one integer n_blocks (`pair_layout`).  In it the standard
    `ShuffleNetV2Block(skip_shuffle=True)` at doubled width computes the
    paired math as it is: its midpoint split is the [R_lo|N_lo] /
    [R_hi|N_hi] boundary;
  * fixed permutations between a producer's layout and a consumer's are
    absorbed into the consumer's kernel columns by the transform, which
    therefore takes fold-shuffled weights
    (`models/reparam.py::fold_shuffle_state_dict`);
  * per-modality reductions (CBAM's spatial mean and max, the P5 add
    `nets/yolo_mul.py:421`, the BiFPN's per-input weights `:36-51`) become
    reductions over a reshaped block axis.

Kernels are OIHW.  The module names are the flax scopes of the JAX
package, so that `models/convert.py` carries JAX paired variables by name.
Use: `pair_backbone_state_dict(fold_shuffle_state_dict(sd))` into
`DCFAYolo(cfg, fold_shuffle=True, pair_backbones=True)`; eval graph only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from dcfa_yolo_tpu_torch.models.backbone import Backbone
from dcfa_yolo_tpu_torch.models.blocks import ChannelAttention, ConvMaxpool, SPPFCBAM
from dcfa_yolo_tpu_torch.ops.conv import Conv

StateDict = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Layout algebra: every paired tensor is alternating equal modality blocks.

def pair_layout(c: int, n_blocks: int) -> Tuple[np.ndarray, np.ndarray]:
    """The paired layout of n_blocks alternating modality blocks over width
    2c, as (mod, ch): paired position p carries modality mod[p] (0 = rgb,
    1 = nir) and that modality's channel ch[p].

    n_blocks=2 → [R(0:c) | N(0:c)]; n_blocks=4 → [R(0:c/2) | N(0:c/2) |
    R(c/2:c) | N(c/2:c)] (the ShuffleNetV2 split layout); n_blocks=8 → the
    SPPF's 4-way concat of blocked pairs."""
    if (2 * c) % n_blocks:
        raise ValueError(f"2·{c} channels do not split into {n_blocks} blocks")
    bl = (2 * c) // n_blocks
    p = np.arange(2 * c)
    b, j = p // bl, p % bl
    return (b % 2).astype(np.int64), ((b // 2) * bl + j).astype(np.int64)


def _pair_dense(kr: torch.Tensor, kn: torch.Tensor, nb_in: int,
                nb_out: int) -> torch.Tensor:
    """Two OIHW kernels (co, ci, kh, kw) → one block-diagonal
    (2co, 2ci, kh, kw) in the given output and input layouts."""
    co, ci = kr.shape[:2]
    mi, chi = pair_layout(ci, nb_in)
    mo, cho = pair_layout(co, nb_out)
    out = kr.new_zeros((2 * co, 2 * ci) + tuple(kr.shape[2:]))
    for mod, k in ((0, kr), (1, kn)):
        rows, cols = np.where(mo == mod)[0], np.where(mi == mod)[0]
        src = k[_idx(cho[rows], k)[:, None], _idx(chi[cols], k)[None, :]]
        out[_idx(rows, k)[:, None], _idx(cols, k)[None, :]] = src
    return out


def _idx(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device)


def _pair_vec(vr: torch.Tensor, vn: torch.Tensor, nb: int) -> torch.Tensor:
    """Per-channel vectors (C,) → paired (2C,) in the given layout."""
    mod, ch = pair_layout(vr.shape[0], nb)
    ch = _idx(ch, vr)
    return torch.where(_idx(mod, vr) == 0, vr[ch], vn[ch])


def _pair_dw(kr: torch.Tensor, kn: torch.Tensor, nb: int) -> torch.Tensor:
    """Depthwise OIHW kernels (C, 1, kh, kw) → (2C, 1, kh, kw)."""
    mod, ch = pair_layout(kr.shape[0], nb)
    ch = _idx(ch, kr)
    return torch.where(_idx(mod, kr).view(-1, 1, 1, 1) == 0, kr[ch], kn[ch])


def _pair_spatial(kr: torch.Tensor, kn: torch.Tensor) -> torch.Tensor:
    """SpatialAttention's two (1, 2, k, k) kernels → (2, 4, k, k): the
    per-modality statistics arrive as [avgR, maxR, avgN, maxN]
    (`PairedSpatialAttention`)."""
    out = kr.new_zeros((2, 4) + tuple(kr.shape[2:]))
    out[0:1, 0:2] = kr
    out[1:2, 2:4] = kn
    return out


# ---------------------------------------------------------------------------
# Paired modules (eval graph only); NCHW like the rest of the model.

def _modality_blocks(x: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """(B, C, H, W) in an n_blocks layout → (B, n_blocks/2, 2, C/n_blocks,
    H, W): axis 2 is the modality of each block."""
    b, c, h, w = x.shape
    return x.view(b, n_blocks // 2, 2, c // n_blocks, h, w)


class PairedSpatialAttention(nn.Module):
    """The spatial gate of each modality over a paired tensor
    (`nets/yolo_mul.py:76-90` per modality): block means and maxes, then the
    modality's mean of its block means (equal blocks: the modality mean up
    to summation order) and max of its maxes → one block-diagonal k×k conv
    → (B, 2, H, W) sigmoid gates, one per modality."""

    def __init__(self, n_blocks: int, kernel_size: int = 7):
        super().__init__()
        self.n_blocks = n_blocks
        self.conv1 = Conv(4, 2, kernel_size, p=3 if kernel_size == 7 else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = _modality_blocks(x, self.n_blocks)
        m = v.mean(dim=3).mean(dim=1)     # (B, 2, H, W)
        mx = v.amax(dim=3).amax(dim=1)
        y = torch.stack([m[:, 0], mx[:, 0], m[:, 1], mx[:, 1]], dim=1)
        return torch.sigmoid(self.conv1(y))


class PairedCBAM(nn.Module):
    """CBAM over a paired tensor: the channel gate is per channel (the
    standard module on block-diagonal MLP weights); the spatial gate scales
    each modality's blocks by that modality's (H, W) map."""

    def __init__(self, c: int, ratio: int = 8, n_blocks: int = 2,
                 kernel_size: int = 7):
        super().__init__()
        self.n_blocks = n_blocks
        self.channelattention = ChannelAttention(c, ratio)
        self.spatialattention = PairedSpatialAttention(n_blocks, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * self.channelattention(x)
        g = self.spatialattention(x)
        b, _, h, w = g.shape
        v = _modality_blocks(x, self.n_blocks) * g.view(b, 1, 2, 1, h, w)
        return v.reshape(x.shape)


class PairedSPPFCBAM(SPPFCBAM):
    """SPPF-CBAM (`nets/yolo_mul.py:10-32`) over the paired stream.  The
    inner CBAMs keep the reference's ratio=c_ collapse per modality:
    hidden width 1 a modality, 2 paired (ratio = paired c_ // 2)."""

    def __init__(self, c_in: int, c_out: int, pool_kernel: int = 5):
        super().__init__(c_in, c_out, pool_kernel)
        c_ = c_in // 2
        for i in range(1, 5):
            setattr(self, f"cbam{i}", PairedCBAM(c_, ratio=c_ // 2, n_blocks=2))


class PairedBackbone(Backbone):
    """Both backbones (`nets/yolo_mul.py:252-308`, twice) as one stream:
    the standard backbone at doubled widths with its units' shuffles
    folded, on the 6-channel [rgb | nir] input, ending in the paired
    SPPF-CBAM.  Emits the paired feat1 and feat2 in the 4-block layout and
    feat3 modality-blocked."""

    def __init__(self, base_channels: int, deep_channels: int):
        bc2, deep2 = 2 * base_channels, 2 * deep_channels
        super().__init__(bc2, deep2, "plain", fold_shuffle=True)
        self.stem = ConvMaxpool(6, bc2, "plain")
        self.dark5_sppf = PairedSPPFCBAM(deep2, deep2, pool_kernel=5)


class PairedConcatBiFPN(nn.Module):
    """`ConcatBiFPN` (`nets/yolo_mul.py:36-51`) taking a paired feat: its
    per-input weights become a per-modality scale on the paired tensor (w1
    on the rgb blocks, w2 on the nir ones: `pair_layout`'s mod mask as a
    broadcast over the block axis).  The parameter is ConcatBiFPN's, so the
    one shared `bi_fpn.w` (`nets/yolo_mul.py:344`) serves as it is."""

    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(3))

    def forward(self, up: torch.Tensor, feat_pair: torch.Tensor,
                n_blocks: int) -> torch.Tensor:
        w = self.w / (self.w.sum() + 1e-4)
        w = w.to(up.dtype)
        v = _modality_blocks(feat_pair, n_blocks) * w[1:3].view(1, 1, 2, 1, 1, 1)
        return torch.cat([w[0] * up, v.reshape(feat_pair.shape)], dim=1)


# ---------------------------------------------------------------------------
# The weight transform (`pair_backbone_variables`, JAX `pairing.py:314-397`).

def _pair_backbone_entry(key: str, kr: torch.Tensor, kn: torch.Tensor) -> torch.Tensor:
    """One entry of the paired backbone from the two backbones' entries;
    `key` is relative to the backbone.  The stem is blocked in and out;
    each dark conv reads its producer's layout (the stem's 2 blocks, then
    the shuffle units' 4) and writes 4 blocks; a shuffle unit's branch
    works in the 2-block coordinates of its paired split half; the SPPF
    reduces 4 blocks to 2, its CBAMs and cv2 read the 2-block maps and
    their 4-way concat (8)."""
    top, rest = key.split(".", 1)
    if top == "dark5_sppf" and rest.startswith("cbam"):
        return _pair_cbam_entry(rest.split(".", 1)[1], kr, kn, 2)
    if top == "stem":
        nb_in, nb_out = 2, 2
    elif top.endswith("_conv"):
        nb_in, nb_out = (2 if top == "dark2_conv" else 4), 4
    elif top.endswith("_shuffle"):
        nb_in, nb_out = 2, 2
    elif top == "dark5_sppf":
        nb_in, nb_out = (4 if rest.startswith("cv1") else 8), 2
    else:
        raise ValueError(f"no pairing rule for backbone entry {key!r}")
    if kr.dim() == 1:
        return _pair_vec(kr, kn, nb_out)
    if rest.startswith("b2_dwconv"):
        return _pair_dw(kr, kn, nb_out)
    return _pair_dense(kr, kn, nb_in, nb_out)


def _pair_cbam_entry(key: str, kr: torch.Tensor, kn: torch.Tensor,
                     nb: int) -> torch.Tensor:
    """One CBAM entry (`key` relative to the CBAM) for a paired input of
    nb blocks: the channel MLP's hidden layer blocked (2), fc1 reading and
    fc2 writing the input's layout; the spatial conv block-diagonal over the
    per-modality statistics."""
    if key == "channelattention.fc1.weight":
        return _pair_dense(kr, kn, nb, 2)
    if key == "channelattention.fc2.weight":
        return _pair_dense(kr, kn, 2, nb)
    if key == "spatialattention.conv1.weight":
        return _pair_spatial(kr, kn)
    raise ValueError(f"no pairing rule for CBAM entry {key!r}")


def pair_backbone_state_dict(sd: StateDict) -> StateDict:
    """The paired graph's state_dict from a fold-shuffled one (train graph
    or deploy; `fold_shuffle_state_dict`), for `DCFAYolo(cfg,
    fold_shuffle=True, pair_backbones=True)`.

    Consumes `backbone_rgb.*` / `backbone_nir.*` / `cbam_{rgb,nir}_feat{1,2,3}.*`
    and emits `backbone_pair.*` / `cbam_pair_feat{1,2,3}.*`.  The
    input-channel columns of the neck's `conv3_for_upsample{1,2}.cv1` are
    re-ordered, since their concat input changes from [up | feat_rgb |
    feat_nir] to [up | paired 4-block] (JAX `:376-392`);
    `conv3_for_downsample2.cv1` is untouched: the paired feat3 is
    modality-blocked, the [down | rgb | nir] order it already reads.  The
    input is left unchanged."""
    out = {k: v for k, v in sd.items()
           if not k.startswith(("backbone_rgb.", "backbone_nir.", "cbam_rgb_",
                                "cbam_nir_"))}
    for key, kr in sd.items():
        if key.startswith("backbone_rgb."):
            rel = key[len("backbone_rgb."):]
            out["backbone_pair." + rel] = _pair_backbone_entry(
                rel, kr, sd["backbone_nir." + rel])
        elif key.startswith("cbam_rgb_"):
            tap, rel = key[len("cbam_rgb_"):].split(".", 1)
            # feat1 / feat2 arrive in the shuffle units' 4-block layout,
            # feat3 (after the SPPF's cv2) modality-blocked
            out[f"cbam_pair_{tap}.{rel}"] = _pair_cbam_entry(
                rel, kr, sd[f"cbam_nir_{tap}.{rel}"], 2 if tap == "feat3" else 4)
    for neck, src in (("conv3_for_upsample2", "dark4_conv"),
                      ("conv3_for_upsample1", "dark5_conv")):
        featc = sd[f"backbone_rgb.{src}.conv.weight"].shape[1]
        key = f"{neck}.cv1.conv.weight"
        k = sd[key]
        pc = k.shape[1] - 2 * featc
        mod, ch = pair_layout(featc, 4)
        cols = np.concatenate([np.arange(pc), pc + mod * featc + ch])
        out[key] = torch.index_select(k, 1, _idx(cols, k))
    return out
