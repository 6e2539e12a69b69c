"""MobileNetV3-Small with GroupNorm (port of
``fedml_tpu.models.mobilenet``): a 3×3 stem, seven inverted-residual blocks
(1×1 expansion, a depthwise 3×3 or 5×5 convolution at stride 1 or 2, an
optional squeeze-excite, 1×1 projection, the residual where the shape is
kept), a 1×1 head to 576 channels, global average pool, Dense(1024) and the
classifier.  Hard-swish ``x·relu6(x + 3)/6`` and hard-sigmoid
``relu6(x + 3)/6`` as flax writes them; GroupNorm ``min(8, channels)``
groups, epsilon 1e-6; flax's ``SAME`` padding (a 5×5 stride-2 convolution
on an even size pads (1, 2)).  Names are flax's
(``InvertedResidual_3.SqueezeExcite_0.Conv_1.bias`` ↔
``InvertedResidual_3/SqueezeExcite_0/Conv_1/bias``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import ConvSame, group_norm

#: (filters, expand, kernel, stride, squeeze-excite) of each block
CFG = ((16, 16, 3, 2, True), (24, 72, 3, 2, False), (24, 88, 3, 1, False),
       (40, 96, 5, 2, True), (40, 240, 5, 1, True), (48, 120, 5, 1, True),
       (96, 288, 5, 2, True))


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * F.relu6(x + 3.0) / 6.0


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduce: int = 4):
        super().__init__()
        mid = max(channels // reduce, 8)
        self.Conv_0 = ConvSame(channels, mid, 1, bias=True)
        self.Conv_1 = ConvSame(mid, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.Conv_0(x.mean(dim=(2, 3), keepdim=True)))
        return x * hard_sigmoid(self.Conv_1(s))


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, filters: int, expand: int, kernel: int,
                 stride: int, use_se: bool):
        super().__init__()
        self.Conv_0 = ConvSame(cin, expand, 1)
        self.GroupNorm_0 = group_norm(expand)
        self.Conv_1 = ConvSame(expand, expand, kernel, stride, groups=expand)
        self.GroupNorm_1 = group_norm(expand)
        self.use_se = use_se
        if use_se:
            self.SqueezeExcite_0 = SqueezeExcite(expand)
        self.Conv_2 = ConvSame(expand, filters, 1)
        self.GroupNorm_2 = group_norm(filters)
        self.residual = stride == 1 and cin == filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = hard_swish(self.GroupNorm_0(self.Conv_0(x)))
        y = hard_swish(self.GroupNorm_1(self.Conv_1(y)))
        if self.use_se:
            y = self.SqueezeExcite_0(y)
        y = self.GroupNorm_2(self.Conv_2(y))
        return y + x if self.residual else y


class MobileNetV3Small(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 3):
        super().__init__()
        self.Conv_0 = ConvSame(in_channels, 16, 3)
        self.GroupNorm_0 = group_norm(16)
        cin = 16
        for i, (f, e, k, s, se) in enumerate(CFG):
            setattr(self, f"InvertedResidual_{i}",
                    InvertedResidual(cin, f, e, k, s, se))
            cin = f
        self.Conv_1 = ConvSame(cin, 576, 1)
        self.GroupNorm_1 = group_norm(576)
        self.Dense_0 = nn.Linear(576, 1024)
        self.Dense_1 = nn.Linear(1024, num_classes)

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        # NCHW in memory (see models/resnet.py)
        x = x.permute(0, 3, 1, 2).contiguous()
        x = hard_swish(self.GroupNorm_0(self.Conv_0(x)))
        for i in range(len(CFG)):
            x = getattr(self, f"InvertedResidual_{i}")(x)
        x = hard_swish(self.GroupNorm_1(self.Conv_1(x)))
        x = hard_swish(self.Dense_0(x.mean(dim=(2, 3))))
        return self.Dense_1(x)
