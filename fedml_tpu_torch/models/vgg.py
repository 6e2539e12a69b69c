"""VGG with GroupNorm (port of ``fedml_tpu.models.vgg``): VGG-11/13/16/19
with each BatchNorm replaced by GroupNorm (``min(8, channels)`` groups,
epsilon 1e-6), 3×3 ``SAME`` convolutions without bias, 2×2 max-pools
(skipped once the input is smaller than 2 on a side, as the reference skips
them at trace time), a global average pool, Dense(512) + ReLU and the
classifier.  Inputs come in NHWC and run in NCHW; names are flax's
(``Conv_3.weight`` ↔ ``Conv_3/kernel``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import ConvSame, group_norm

#: the reference's cfg lists: filters of a convolution, "M" a max-pool
CFGS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    13: (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
         512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


class VGG(nn.Module):
    def __init__(self, cfg: Sequence, num_classes: int, in_channels: int,
                 dense_dim: int = 512):
        super().__init__()
        self.cfg = tuple(cfg)
        cin, n = in_channels, 0
        for v in self.cfg:
            if v != "M":
                setattr(self, f"Conv_{n}", ConvSame(cin, int(v), 3))
                setattr(self, f"GroupNorm_{n}", group_norm(int(v)))
                cin, n = int(v), n + 1
        self.Dense_0 = nn.Linear(cin, dense_dim)
        self.Dense_1 = nn.Linear(dense_dim, num_classes)

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        if x.ndim == 3:
            x = x[..., None]
        # NCHW in memory (see models/resnet.py)
        x = x.permute(0, 3, 1, 2).contiguous()
        n = 0
        for v in self.cfg:
            if v == "M":
                if min(x.shape[-2:]) >= 2:
                    x = F.max_pool2d(x, 2, 2)
            else:
                x = getattr(self, f"GroupNorm_{n}")(
                    getattr(self, f"Conv_{n}")(x))
                x, n = F.relu(x), n + 1
        x = F.relu(self.Dense_0(x.mean(dim=(2, 3))))
        return self.Dense_1(x)


def vgg(depth: int, num_classes: int, in_channels: int = 3) -> VGG:
    return VGG(CFGS[depth], num_classes, in_channels)
