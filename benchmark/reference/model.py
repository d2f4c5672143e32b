"""Plain PyTorch reference of the DCFA-YOLO detector (train graph), frozen
for the benchmark.

It follows the reference network (`nets/yolo_mul.py`, `nets/repghost.py` of
https://github.com/heitieya/DCFA-YOLO) in the layouts the port keeps: NHWC
images in, anchors-first outputs.  Every convolution, BatchNorm and pool is
a plain `torch` call in float32; there is no kernel, no CUDA graph, no
serving transform (RepGhost fusion, shuffle fold, weight casts) and no
data-parallel path.  The eval forward of this train graph is what the
served deploy-and-fold graph computes, so the reference works those
transforms out again by not making them.

`precision`: float32, or a lower precision in which every operation of
the network's maps is rounded (`reference.precision.rounding`; the
precision control's fp8).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reference.precision import rounding

DEPTH = {"n": 0.33, "s": 0.33, "m": 0.67, "l": 1.00, "x": 1.00}
WIDTH = {"n": 0.25, "s": 0.50, "m": 0.75, "l": 1.00, "x": 1.25}
DEEP = {"n": 1.00, "s": 1.00, "m": 0.75, "l": 0.50, "x": 0.50}
STRIDES = (8, 16, 32)


class Sizes(NamedTuple):
    phi: str
    num_classes: int
    reg_max: int
    input_hw: Tuple[int, int]

    @property
    def base_channels(self) -> int:
        return int(WIDTH[self.phi] * 64)

    @property
    def base_depth(self) -> int:
        return max(round(DEPTH[self.phi] * 3), 1)

    @property
    def deep_channels(self) -> int:
        return int(self.base_channels * 16 * DEEP[self.phi])


class Conv(nn.Conv2d):
    """A bias-optional conv with 'same' padding."""

    def __init__(self, c_in, c_out, k=1, s=1, p=None, g=1, bias=False):
        super().__init__(c_in, c_out, k, s, k // 2 if p is None else p, groups=g,
                         bias=bias)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1: eval folds the running statistics; train
    normalises by the batch mean and mean² (var = max(E[x²] − E[x]², 0)) and
    moves the running statistics with torch's momentum and the Bessel
    factor."""

    def __init__(self, c, eps=1e-5, momentum=0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        shape = (1, -1, 1, 1)
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            return x * inv.view(shape) + (self.bias - self.running_mean * inv).view(shape)
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1.0, 1.0)))
        y = (x - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        return y * self.weight.view(shape) + self.bias.view(shape)


def silu(x):
    return x * torch.sigmoid(x)


class ConvBnAct(nn.Module):
    def __init__(self, c_in, c_out, k=1, s=1, bn_eps=1e-3, bn_momentum=0.03):
        super().__init__()
        self.conv = Conv(c_in, c_out, k, s)
        self.bn = BatchNorm(c_out, eps=bn_eps, momentum=bn_momentum)

    def forward(self, x):
        return silu(self.bn(self.conv(x)))


class ChannelAttention(nn.Module):
    def __init__(self, c, ratio=8):
        super().__init__()
        self.fc1 = Conv(c, c // ratio, 1)
        self.fc2 = Conv(c // ratio, c, 1)

    def forward(self, x):
        avg = self.fc2(torch.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        mx = self.fc2(torch.relu(self.fc1(x.amax(dim=(2, 3), keepdim=True))))
        return torch.sigmoid(avg + mx)


class SpatialAttention(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv(2, 1, 7, p=3)

    def forward(self, x):
        y = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], 1)
        return torch.sigmoid(self.conv1(y))


class CBAM(nn.Module):
    def __init__(self, c, ratio=8):
        super().__init__()
        self.channelattention = ChannelAttention(c, ratio)
        self.spatialattention = SpatialAttention()

    def forward(self, x):
        x = x * self.channelattention(x)
        return x * self.spatialattention(x)


class ConvMaxpool(nn.Module):
    """Stem: 3x3 conv, BN (torch defaults), ReLU, 3x3 s2 max pool."""

    def __init__(self, c_in, c_out):
        super().__init__()
        self.conv = Conv(c_in, c_out, 3, 1)
        self.bn = BatchNorm(c_out)

    def forward(self, x):
        return F.max_pool2d(torch.relu(self.bn(self.conv(x))), 3, 2, 1)


def channel_shuffle(x, groups=2):
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)


class ShuffleNetV2Block(nn.Module):
    def __init__(self, c):
        super().__init__()
        bf = c // 2
        self.b2_conv1 = Conv(bf, bf, 1)
        self.b2_bn1 = BatchNorm(bf)
        self.b2_dwconv = Conv(bf, bf, 3, 1, g=bf, bias=True)
        self.b2_bn2 = BatchNorm(bf)
        self.b2_conv3 = Conv(bf, bf, 1)
        self.b2_bn3 = BatchNorm(bf)

    def forward(self, x):
        x1, x2 = x.chunk(2, dim=1)
        y = torch.relu(self.b2_bn1(self.b2_conv1(x2)))
        y = self.b2_bn2(self.b2_dwconv(y))
        y = torch.relu(self.b2_bn3(self.b2_conv3(y)))
        return channel_shuffle(torch.cat([x1, y], 1))


class SPPFCBAM(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        c_ = c_in // 2
        self.cv1 = ConvBnAct(c_in, c_, 1, 1)
        self.cbam1 = CBAM(c_, ratio=c_)
        self.cbam2 = CBAM(c_, ratio=c_)
        self.cbam3 = CBAM(c_, ratio=c_)
        self.cbam4 = CBAM(c_, ratio=c_)
        self.cv2 = ConvBnAct(4 * c_, c_out, 1, 1)

    def forward(self, x):
        x = self.cbam1(self.cv1(x))
        y1 = self.cbam2(F.max_pool2d(x, 5, 1, 2))
        y2 = self.cbam3(F.max_pool2d(y1, 5, 1, 2))
        y3 = self.cbam4(F.max_pool2d(y2, 5, 1, 2))
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


class Backbone(nn.Module):
    def __init__(self, bc, deep):
        super().__init__()
        self.stem = ConvMaxpool(3, bc)
        self.dark2_conv = ConvBnAct(bc, bc * 2, 3, 2)
        self.dark2_shuffle = ShuffleNetV2Block(bc * 2)
        self.dark3_conv = ConvBnAct(bc * 2, bc * 4, 3, 2)
        self.dark3_shuffle = ShuffleNetV2Block(bc * 4)
        self.dark4_conv = ConvBnAct(bc * 4, bc * 8, 3, 2)
        self.dark4_shuffle = ShuffleNetV2Block(bc * 8)
        self.dark5_conv = ConvBnAct(bc * 8, deep, 3, 2)
        self.dark5_shuffle = ShuffleNetV2Block(deep)
        self.dark5_sppf = SPPFCBAM(deep, deep)

    def forward(self, x):
        x = self.dark2_shuffle(self.dark2_conv(self.stem(x)))
        feat1 = self.dark3_shuffle(self.dark3_conv(x))
        feat2 = self.dark4_shuffle(self.dark4_conv(feat1))
        feat3 = self.dark5_sppf(self.dark5_shuffle(self.dark5_conv(feat2)))
        return feat1, feat2, feat3


class ConcatBiFPN(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.ones(3))

    def forward(self, xs):
        w = self.w / (self.w.sum() + 1e-4)
        return torch.cat([w[0] * xs[0], w[1] * xs[1], w[2] * xs[2]], 1)


class RepGhostModule(nn.Module):
    def __init__(self, c_in, c_out, relu=True):
        super().__init__()
        self.relu = relu
        self.primary_conv = Conv(c_in, c_out, 1, p=0)
        self.primary_bn = BatchNorm(c_out)
        self.cheap_conv = Conv(c_out, c_out, 3, 1, p=1, g=c_out)
        self.cheap_bn = BatchNorm(c_out)
        self.fusion_bn = BatchNorm(c_out)

    def forward(self, x):
        x1 = self.primary_bn(self.primary_conv(x))
        if self.relu:
            x1 = silu(x1)
        x2 = self.cheap_bn(self.cheap_conv(x1)) + self.fusion_bn(x1)
        return silu(x2) if self.relu else x2


class RepGhostBottleneck(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.ghost1 = RepGhostModule(c, c, relu=True)
        self.ghost2 = RepGhostModule(c, c, relu=False)

    def forward(self, x):
        return self.ghost2(self.ghost1(x)) + x


class C2fRepGhost(nn.Module):
    def __init__(self, c_in, c_out, n=1):
        super().__init__()
        self.c = int(c_out * 0.5)
        self.n = n
        self.cv1 = ConvBnAct(c_in, 2 * self.c, 1, 1, bn_eps=1e-5, bn_momentum=0.1)
        for i in range(n):
            self.add_module(f"m{i}", RepGhostBottleneck(self.c))
        self.cv2 = ConvBnAct((2 + n) * self.c, c_out, 1, 1, bn_eps=1e-5,
                             bn_momentum=0.1)

    def forward(self, x):
        y = list(self.cv1(x).split(self.c, dim=1))
        for i in range(self.n):
            y.append(getattr(self, f"m{i}")(y[-1]))
        return self.cv2(torch.cat(y, 1))


def linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear align_corners=True interpolation matrix."""
    pos = (np.zeros(1) if n_out == 1
           else np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1))
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    w = pos - lo
    mat = np.zeros((n_out, n_in), np.float32)
    mat[np.arange(n_out), lo] += (1.0 - w).astype(np.float32)
    mat[np.arange(n_out), hi] += w.astype(np.float32)
    return mat


def make_anchors(input_hw, strides=STRIDES):
    """(A, 2) anchor centres in feature units and (A, 1) strides, levels
    in stride order, rows y-major."""
    h, w = input_hw
    pts, st = [], []
    for s in strides:
        fh, fw = h // s, w // s
        gy, gx = np.meshgrid(np.arange(fh, dtype=np.float32) + 0.5,
                             np.arange(fw, dtype=np.float32) + 0.5, indexing="ij")
        pts.append(np.stack([gx, gy], -1).reshape(-1, 2))
        st.append(np.full((fh * fw, 1), s, np.float32))
    return np.concatenate(pts), np.concatenate(st)


class Outputs(NamedTuple):
    dbox: torch.Tensor    # (B, A, 4) DFL-decoded ltrb distances, feature units
    cls: torch.Tensor     # (B, A, nc) class logits
    feats: Tuple[torch.Tensor, ...]  # per-level NHWC (B, h, w, 4·reg_max + nc)
    anchors: torch.Tensor  # (A, 2)
    strides: torch.Tensor  # (A, 1)


class ReferenceYolo(nn.Module):
    """The dual-backbone detector; parameter names are the port's train
    graph's, so one state_dict loads into both."""

    def __init__(self, sizes: Sizes, precision: str = "float32"):
        super().__init__()
        self.sizes = sizes
        bc, deep, depth = sizes.base_channels, sizes.deep_channels, sizes.base_depth
        self.backbone_rgb = Backbone(bc, deep)
        self.backbone_nir = Backbone(bc, deep)
        for mod in ("rgb", "nir"):
            for i, c in enumerate((bc * 4, bc * 8, deep), start=1):
                self.add_module(f"cbam_{mod}_feat{i}", CBAM(c))
        self.bi_fpn = ConcatBiFPN()
        self.conv3_for_upsample1 = C2fRepGhost(deep + 2 * bc * 8, bc * 8, depth)
        self.conv3_for_upsample2 = C2fRepGhost(bc * 8 + 2 * bc * 4, bc * 4, depth)
        self.down_sample1 = ConvBnAct(bc * 4, bc * 4, 3, 2)
        self.conv3_for_downsample1 = C2fRepGhost(bc * 4 + bc * 8, bc * 8, depth)
        self.down_sample2 = ConvBnAct(bc * 8, bc * 8, 3, 2)
        self.conv3_for_downsample2 = C2fRepGhost(bc * 8 + 2 * deep, deep, depth)
        ch = (bc * 4, bc * 8, deep)
        nc, rm = sizes.num_classes, sizes.reg_max
        c2, c3 = max(16, ch[0] // 4, rm * 4), max(ch[0], nc)
        for i, c in enumerate(ch):
            self.add_module(f"cv2_{i}_0", ConvBnAct(c, c2, 3))
            self.add_module(f"cv2_{i}_1", ConvBnAct(c2, c2, 3))
            self.add_module(f"cv2_{i}_2", Conv(c2, 4 * rm, 1, bias=True))
            self.add_module(f"cv3_{i}_0", ConvBnAct(c, c3, 3))
            self.add_module(f"cv3_{i}_1", ConvBnAct(c3, c3, 3))
            self.add_module(f"cv3_{i}_2", Conv(c3, nc, 1, bias=True))
        self.precision = precision

    def _resize(self, x, hw):
        """Bilinear align_corners=True upsample as two matrix products."""
        ah = torch.from_numpy(linear_matrix(x.shape[2], hw[0])).to(x)
        aw = torch.from_numpy(linear_matrix(x.shape[3], hw[1])).to(x)
        return torch.matmul(torch.matmul(ah, x), aw.t())

    def maps(self, rgb: torch.Tensor, nir: torch.Tensor) -> List[torch.Tensor]:
        """Per-level NCHW head maps concat([box, cls]), in the model's
        precision.  rgb/nir: NHWC in [0, 1]."""
        with rounding(self.precision):
            return self._maps(rgb, nir)

    def _maps(self, rgb, nir):
        f1r, f2r, f3r = self.backbone_rgb(rgb.permute(0, 3, 1, 2))
        f1n, f2n, f3n = self.backbone_nir(nir.permute(0, 3, 1, 2))
        feats = ((self.cbam_rgb_feat1(f1r), self.cbam_nir_feat1(f1n)),
                 (self.cbam_rgb_feat2(f2r), self.cbam_nir_feat2(f2n)),
                 (self.cbam_rgb_feat3(f3r), self.cbam_nir_feat3(f3n)))
        feat3 = feats[2][0] + feats[2][1]
        p5_up = self._resize(feat3, feats[1][0].shape[2:4])
        p4 = self.conv3_for_upsample1(self.bi_fpn((p5_up, *feats[1])))
        p4_up = self._resize(p4, feats[0][0].shape[2:4])
        p3 = self.conv3_for_upsample2(self.bi_fpn((p4_up, *feats[0])))
        p4 = self.conv3_for_downsample1(torch.cat([self.down_sample1(p3), p4], 1))
        p5 = self.conv3_for_downsample2(self.bi_fpn((self.down_sample2(p4), *feats[2])))
        out = []
        for i, p in enumerate((p3, p4, p5)):
            box = getattr(self, f"cv2_{i}_2")(getattr(self, f"cv2_{i}_1")(
                getattr(self, f"cv2_{i}_0")(p)))
            cls = getattr(self, f"cv3_{i}_2")(getattr(self, f"cv3_{i}_1")(
                getattr(self, f"cv3_{i}_0")(p)))
            out.append(torch.cat([box, cls], 1))
        return out

    def train_feats(self, rgb, nir) -> Tuple[torch.Tensor, ...]:
        """The per-level NHWC maps the loss reads."""
        return tuple(m.permute(0, 2, 3, 1) for m in self.maps(rgb, nir))

    def forward(self, rgb, nir) -> Outputs:
        rm = self.sizes.reg_max
        maps = self.maps(rgb, nir)
        b = maps[0].shape[0]
        flat = torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, m.shape[1]) for m in maps], 1)
        box, cls = flat[..., :4 * rm], flat[..., 4 * rm:]
        anchors, strides = (torch.from_numpy(a).to(flat) for a in
                            make_anchors(tuple(rgb.shape[1:3])))
        return Outputs(dfl_decode(box, rm), cls,
                       tuple(m.permute(0, 2, 3, 1) for m in maps), anchors, strides)


def dfl_decode(box_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Softmax over each side's reg_max bins → expected distance."""
    x = box_logits.reshape(*box_logits.shape[:-1], 4, reg_max).softmax(dim=-1)
    return (x * torch.arange(reg_max, dtype=x.dtype, device=x.device)).sum(-1)


def state_names(sizes: Sizes) -> Sequence[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every state_dict entry of the train graph, built on
    the meta device."""
    with torch.device("meta"):
        model = ReferenceYolo(sizes)
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]


def shuffle_rows(c: int) -> np.ndarray:
    """The rows at which a consumer of `channel_shuffle`'s output takes its
    input channels once it reads the unshuffled map instead: the inverse of
    the shuffle's permutation, read off `channel_shuffle` itself."""
    perm = channel_shuffle(torch.arange(c, dtype=torch.float64).reshape(1, c, 1, 1))
    return np.argsort(perm.reshape(-1).numpy().astype(np.int64))


def fold_spec(shapes: Dict[str, Sequence[int]]) -> List[Tuple[str, int, np.ndarray]]:
    """The backbones' channel shuffles folded into their consumers' weights,
    as data: [(key, axis, rows)] with folded = index_select(w, axis, rows),
    for a state whose entries have `shapes` (a frozen copy of the port's
    training layout under `--fold-shuffle`).  The consumers of a shuffled
    map: dark{3,4,5}_conv and dark5_sppf.cv1 in each backbone, the feat1 and
    feat2 CBAMs' channel MLP (fc1's input rows, fc2's output rows), and the
    feat segments of the neck's conv3_for_upsample{1,2}.cv1 inputs
    (p_up, feat_rgb, feat_nir)."""
    spec = []
    for bk in ("backbone_rgb", "backbone_nir"):
        for consumer in ("dark3_conv", "dark4_conv", "dark5_conv", "dark5_sppf.cv1"):
            key = f"{bk}.{consumer}.conv.weight"
            spec.append((key, 1, shuffle_rows(shapes[key][1])))
    for tap in ("feat1", "feat2"):
        for mod in ("rgb", "nir"):
            ca = f"cbam_{mod}_{tap}.channelattention"
            rows = shuffle_rows(shapes[f"{ca}.fc1.weight"][1])
            spec += [(f"{ca}.fc1.weight", 1, rows), (f"{ca}.fc2.weight", 0, rows)]
    for neck, feat_src in (("conv3_for_upsample2", "dark4_conv"),
                           ("conv3_for_upsample1", "dark5_conv")):
        featc = shapes[f"backbone_rgb.{feat_src}.conv.weight"][1]
        key = f"{neck}.cv1.conv.weight"
        pc = shapes[key][1] - 2 * featc
        rows = shuffle_rows(featc)
        spec.append((key, 1, np.concatenate([np.arange(pc), pc + rows, pc + featc + rows])))
    return spec


def unfold(d: Dict[str, torch.Tensor], spec, prefixes: Sequence[str] = ("", "ema.")
           ) -> Dict[str, torch.Tensor]:
    """`d` (weights, or their gradients, changes or moments, keyed as the
    state, optionally under `prefixes`) from the folded layout back to the
    reference's: each folded entry's rows taken at argsort(rows)."""
    out = dict(d)
    for key, axis, rows in spec:
        idx = torch.as_tensor(np.argsort(rows))
        for pre in prefixes:
            if pre + key in out:
                t = out[pre + key]
                out[pre + key] = torch.index_select(t, axis, idx.to(t.device))
    return out
