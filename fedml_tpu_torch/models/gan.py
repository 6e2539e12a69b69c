"""GAN generator/discriminator pair (port of ``fedml_tpu.models.gan``):
DCGAN-shaped, with GroupNorm in place of BatchNorm, sized for 28×28 and
32×32 federated vision sets.

Images keep the dataset's NHWC layout at the API; the convolutions run in
NCHW.  The Generator's first GroupNorm normalises the Dense output
``(B, F)`` in 8 groups of F/8 features; its transposed convolutions are
flax's k 4 s 2 ``"SAME"`` (``ConvTranspose2d`` padding 1), and its output
is cropped to ``out_hw`` before the ``tanh``.  The Discriminator's convs
carry biases, and it flattens its features in NHWC order as flax does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import GN_EPS, ConvSame
from .unet import ConvTransposeSame


class Generator(nn.Module):
    """z (B, latent_dim) → image (B, H, W, C) in [-1, 1]."""

    def __init__(self, out_hw: int = 28, out_channels: int = 1,
                 latent_dim: int = 64, base: int = 64):
        super().__init__()
        self.out_hw, self.latent_dim, self.base = out_hw, latent_dim, base
        self.h0 = out_hw // 4
        width = self.h0 * self.h0 * base * 2
        self.Dense_0 = nn.Linear(latent_dim, width)
        self.GroupNorm_0 = nn.GroupNorm(8, width, eps=GN_EPS)
        self.ConvTranspose_0 = ConvTransposeSame(base * 2, base, 4, 2)
        self.GroupNorm_1 = nn.GroupNorm(8, base, eps=GN_EPS)
        self.ConvTranspose_1 = ConvTransposeSame(base, out_channels, 4, 2)

    def forward(self, z: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        x = F.relu(self.GroupNorm_0(self.Dense_0(z)))
        x = x.reshape(-1, self.h0, self.h0, self.base * 2).permute(0, 3, 1, 2)
        x = F.relu(self.GroupNorm_1(self.ConvTranspose_0(x)))
        x = self.ConvTranspose_1(x)[:, :, :self.out_hw, :self.out_hw]
        return torch.tanh(x).permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    """image (B, H, W, C) → real/fake logit (B,)."""

    def __init__(self, base: int = 64, in_hw: int = 28, in_channels: int = 1):
        super().__init__()
        self.Conv_0 = ConvSame(in_channels, base, 4, 2, bias=True)
        self.Conv_1 = ConvSame(base, base * 2, 4, 2, bias=True)
        self.GroupNorm_0 = nn.GroupNorm(8, base * 2, eps=GN_EPS)
        hw = -(-(-(-in_hw // 2)) // 2)
        self.Dense_0 = nn.Linear(hw * hw * base * 2, 1)

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        x = F.leaky_relu(self.Conv_0(x.permute(0, 3, 1, 2).contiguous()), 0.2)
        x = F.leaky_relu(self.GroupNorm_0(self.Conv_1(x)), 0.2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.Dense_0(x)[:, 0]
