"""ShuffleNetV2/SPPF-CBAM backbone (`dcfa_yolo_tpu/models/backbone.py`,
reference `nets/yolo_mul.py:252-308`)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dcfa_yolo_tpu_torch.models.blocks import (ConvMaxpool, SPPFCBAM,
                                               ShuffleNetV2Block)
from dcfa_yolo_tpu_torch.ops.conv import ConvBnAct


class Backbone(nn.Module):
    """stem → dark2..dark5; each dark = s2 ConvBnAct + s1 ShuffleNetV2 unit;
    dark5 appends SPPF-CBAM.  Emits feats at /8, /16, /32 (NCHW).
    fold_shuffle: the ShuffleNet units skip their final shuffle (JAX
    `backbone.py:20,32`), for weights from `fold_shuffle_state_dict`."""

    def __init__(self, base_channels: int, deep_channels: int,
                 stem_backend: str = "auto", fold_shuffle: bool = False):
        super().__init__()
        bc, deep = base_channels, deep_channels
        self.stem = ConvMaxpool(3, bc, stem_backend)
        self.dark2_conv = ConvBnAct(bc, bc * 2, 3, 2)
        self.dark2_shuffle = ShuffleNetV2Block(bc * 2, fold_shuffle)
        self.dark3_conv = ConvBnAct(bc * 2, bc * 4, 3, 2)
        self.dark3_shuffle = ShuffleNetV2Block(bc * 4, fold_shuffle)
        self.dark4_conv = ConvBnAct(bc * 4, bc * 8, 3, 2)
        self.dark4_shuffle = ShuffleNetV2Block(bc * 8, fold_shuffle)
        self.dark5_conv = ConvBnAct(bc * 8, deep, 3, 2)
        self.dark5_shuffle = ShuffleNetV2Block(deep, fold_shuffle)
        self.dark5_sppf = SPPFCBAM(deep, deep, pool_kernel=5)

    def forward(self, x: Optional[torch.Tensor],
                stem_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: NCHW input, or None when `stem_out` (the /2 pooled NCHW map
        from the fused stem kernel) is given; the stem's parameters then
        stay in the module, unread, as in the JAX package (`:34-38`)."""
        x = self.stem(x) if stem_out is None else stem_out
        x = self.dark2_shuffle(self.dark2_conv(x))
        feat1 = self.dark3_shuffle(self.dark3_conv(x))
        feat2 = self.dark4_shuffle(self.dark4_conv(feat1))
        x = self.dark5_shuffle(self.dark5_conv(feat2))
        feat3 = self.dark5_sppf(x)
        return feat1, feat2, feat3
