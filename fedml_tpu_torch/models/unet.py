"""Small UNet for federated segmentation (port of ``fedml_tpu.models.unet``):
a two-level encoder/decoder with skip connections and GroupNorm
(``min(8, C)`` groups, epsilon 1e-6), whose output is per-pixel class
logits ``(B, H, W, num_classes)``; and ``mean_iou``.

Inputs and logits keep the dataset's NHWC layout; the convolutions run in
NCHW.  ``ConvTransposeSame`` is flax's ``nn.ConvTranspose`` with its
default ``padding="SAME"``, which :func:`transpose_same_pads` translates
into ``ConvTranspose2d``'s padding (the kernel's layout is
``models/convert.py``'s ``conv_transpose`` kind).  Parameter names are
flax's (``_ConvBlock_3.Conv_1.weight`` ↔ ``_ConvBlock_3/Conv_1/kernel``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import ConvSame, group_norm


def transpose_same_pads(k: int, stride: int):
    """(lo, hi) padding that ``lax.conv_transpose`` gives ``"SAME"``: pads
    of the stride-dilated input, before the kernel runs over it."""
    total = k + stride - 2
    lo = k - 1 if stride > k - 1 else -(-total // 2)
    return lo, total - lo


class ConvTransposeSame(nn.ConvTranspose2d):
    """``nn.ConvTranspose`` with ``padding="SAME"`` and a bias.  Torch pads
    the dilated input by ``k - 1 - padding`` on both sides, so only flax's
    symmetric cases translate (k 2 s 2 → 0, k 4 s 2 → 1)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        lo, hi = transpose_same_pads(k, stride)
        if lo != hi:
            raise ValueError(f"SAME transposed convolution k {k} stride "
                             f"{stride} pads ({lo}, {hi}): not symmetric")
        super().__init__(cin, cout, k, stride=stride, padding=k - 1 - lo)


class _ConvBlock(nn.Module):
    def __init__(self, cin: int, channels: int):
        super().__init__()
        self.Conv_0 = ConvSame(cin, channels, 3)
        self.GroupNorm_0 = group_norm(channels)
        self.Conv_1 = ConvSame(channels, channels, 3)
        self.GroupNorm_1 = group_norm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        return F.relu(self.GroupNorm_1(self.Conv_1(x)))


class UNetSmall(nn.Module):
    def __init__(self, num_classes: int = 2, base: int = 16,
                 in_channels: int = 1):
        super().__init__()
        b = base
        blocks = [(in_channels, b), (b, 2 * b), (2 * b, 4 * b),
                  (4 * b, 2 * b), (2 * b, b)]
        for i, (cin, cout) in enumerate(blocks):
            setattr(self, f"_ConvBlock_{i}", _ConvBlock(cin, cout))
        self.ConvTranspose_0 = ConvTransposeSame(4 * b, 2 * b, 2, 2)
        self.ConvTranspose_1 = ConvTransposeSame(2 * b, b, 2, 2)
        self.Conv_0 = nn.Conv2d(b, num_classes, 1)

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous()
        d1 = self._ConvBlock_0(x)
        d2 = self._ConvBlock_1(F.max_pool2d(d1, 2))
        mid = self._ConvBlock_2(F.max_pool2d(d2, 2))
        u2 = self._ConvBlock_3(torch.cat([self.ConvTranspose_0(mid), d2], 1))
        u1 = self._ConvBlock_4(torch.cat([self.ConvTranspose_1(u2), d1], 1))
        return self.Conv_0(u1).permute(0, 2, 3, 1)


def mean_iou(logits: torch.Tensor, labels: torch.Tensor,
             num_classes: int) -> torch.Tensor:
    """mIoU over a batch: logits (B, H, W, C), labels (B, H, W) int; a class
    absent from both prediction and labels counts as IoU 1."""
    pred = torch.argmax(logits, dim=-1)
    ious = []
    for c in range(num_classes):
        p, t = pred == c, labels == c
        inter = torch.sum(p & t).to(torch.float32)
        union = torch.sum(p | t).to(torch.float32)
        ious.append(torch.where(union > 0, inter / union,
                                torch.ones_like(union)))
    return torch.mean(torch.stack(ious))
