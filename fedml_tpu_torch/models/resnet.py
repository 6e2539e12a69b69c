"""ResNets with GroupNorm (port of ``fedml_tpu.models.resnet``):
``resnet18_gn`` (2-2-2-2 blocks, width 64) and its width variants,
``resnet20`` and ``resnet56`` (3 stages of 3 and 9 blocks, width 16), each
with the CIFAR stem (one 3×3 convolution, no pooling).

Inputs come in the dataset's NHWC layout and the convolutions run in
NCHW.  flax's ``padding="SAME"`` is XLA's rule: ``total = max((out − 1)·
stride + k − size, 0)``, ``lo = total // 2``, ``hi = total − lo``.  At
stride 1 a 3×3 kernel pads (1, 1); at stride 2 on an even size it pads
(0, 1), not PyTorch's symmetric (1, 1); the 1×1 stride-2 shortcut pads
nothing.  GroupNorm takes ``min(8, channels)`` groups, epsilon 1e-6
(flax's default); the features are averaged over H and W before the
Dense.  Parameter names are flax's (``BasicBlock_3.Conv_2.weight`` ↔
``BasicBlock_3/Conv_2/kernel``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6   # flax nn.GroupNorm's default


def same_pads(size: int, k: int, stride: int):
    """(lo, hi) padding of flax/XLA ``SAME`` along one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class ConvSame(nn.Conv2d):
    """``nn.Conv`` with ``padding="SAME"``; no bias unless asked
    (``use_bias``), ``groups`` as flax's ``feature_group_count`` (a
    depthwise convolution has ``groups == cin == cout``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = False, groups: int = 1):
        super().__init__(cin, cout, k, stride=stride, bias=bias,
                         groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        (ht, hb), (wl, wr) = (same_pads(x.shape[-2], k, s),
                              same_pads(x.shape[-1], k, s))
        if ht or hb or wl or wr:
            x = F.pad(x, (wl, wr, ht, hb))
        return self._conv_forward(x, self.weight, self.bias)


def group_norm(channels: int, groups: int = 8) -> nn.GroupNorm:
    return nn.GroupNorm(min(groups, channels), channels, eps=GN_EPS)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = ConvSame(cin, filters, 3, stride)
        self.GroupNorm_0 = group_norm(filters)
        self.Conv_1 = ConvSame(filters, filters, 3)
        self.GroupNorm_1 = group_norm(filters)
        # the shortcut projection wherever the block changes the shape
        self.project = stride != 1 or cin != filters
        if self.project:
            self.Conv_2 = ConvSame(cin, filters, 1, stride)
            self.GroupNorm_2 = group_norm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        if self.project:
            x = self.GroupNorm_2(self.Conv_2(x))
        return F.relu(y + x)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int,
                 width: int = 64):
        super().__init__()
        self.Conv_0 = ConvSame(3, width, 3)   # the CIFAR stem
        self.GroupNorm_0 = nn.GroupNorm(8, width, eps=GN_EPS)
        self.n_blocks = 0
        cin = width
        for i, n in enumerate(stage_sizes):
            filters = width * 2 ** i
            for j in range(n):
                stride = 2 if i > 0 and j == 0 else 1
                setattr(self, f"BasicBlock_{self.n_blocks}",
                        BasicBlock(cin, filters, stride))
                self.n_blocks += 1
                cin = filters
        self.Dense_0 = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        # NCHW in memory too: on the CPU a channels-last input sends the
        # convolutions down oneDNN's channels-last path, whose backward
        # corrupted the heap at some batch sizes (torch 2.13, 4 and 20)
        x = x.permute(0, 3, 1, 2).contiguous()
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def resnet18_gn(num_classes: int, width: int = 64) -> ResNet:
    return ResNet((2, 2, 2, 2), num_classes, width)


def resnet56(num_classes: int) -> ResNet:
    return ResNet((9, 9, 9), num_classes, width=16)


def resnet20(num_classes: int) -> ResNet:
    return ResNet((3, 3, 3), num_classes, width=16)
