"""EfficientNet-lite with GroupNorm (port of
``fedml_tpu.models.efficientnet``): a 3×3 stride-2 stem, B0-shaped MBConv
stages (an optional 1×1 expansion, a depthwise 3×3 or 5×5 convolution, a
squeeze-excite with biases, 1×1 projection, the residual where the shape
is kept), a 1×1 head to 192 channels, global average pool and the
classifier.  Swish activations; GroupNorm ``min(8, channels)`` groups,
epsilon 1e-6; flax's ``SAME`` padding.  A block's layers are numbered in
the order flax creates them (``MBConv_1.Conv_4.weight`` ↔
``MBConv_1/Conv_4/kernel``, the projection of an expanding block).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import ConvSame, group_norm

#: (filters, expand, kernel, stride, repeats) per stage: B0-lite
STAGES = ((16, 1, 3, 1, 1), (24, 4, 3, 2, 2), (40, 4, 5, 2, 2),
          (80, 4, 3, 2, 2), (112, 4, 5, 1, 1))


class MBConv(nn.Module):
    def __init__(self, cin: int, filters: int, expand_ratio: int,
                 kernel: int, stride: int, se_reduce: int = 4):
        super().__init__()
        mid, se = cin * expand_ratio, max(cin // se_reduce, 4)
        layers = []   # (role, layer) in the order flax creates them
        if expand_ratio != 1:
            layers += [("expand", ConvSame(cin, mid, 1)),
                       ("expand_norm", group_norm(mid))]
        layers += [("depthwise", ConvSame(mid, mid, kernel, stride,
                                          groups=mid)),
                   ("depthwise_norm", group_norm(mid)),
                   ("se_reduce", ConvSame(mid, se, 1, bias=True)),
                   ("se_expand", ConvSame(se, mid, 1, bias=True)),
                   ("project", ConvSame(mid, filters, 1)),
                   ("project_norm", group_norm(filters))]
        self.names, counts = {}, {}
        for role, layer in layers:
            kind = "Conv" if isinstance(layer, nn.Conv2d) else "GroupNorm"
            self.names[role] = f"{kind}_{counts.get(kind, 0)}"
            counts[kind] = counts.get(kind, 0) + 1
            self.add_module(self.names[role], layer)
        self.residual = stride == 1 and cin == filters

    def layer(self, role: str) -> nn.Module:
        return getattr(self, self.names[role])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if "expand" in self.names:
            y = F.silu(self.layer("expand_norm")(self.layer("expand")(y)))
        y = F.silu(self.layer("depthwise_norm")(self.layer("depthwise")(y)))
        s = F.silu(self.layer("se_reduce")(y.mean(dim=(2, 3), keepdim=True)))
        y = y * torch.sigmoid(self.layer("se_expand")(s))
        y = self.layer("project_norm")(self.layer("project")(y))
        return y + x if self.residual else y


class EfficientNetLite(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 3):
        super().__init__()
        self.Conv_0 = ConvSame(in_channels, 32, 3, 2)
        self.GroupNorm_0 = group_norm(32)
        cin, self.n_blocks = 32, 0
        for filters, expand, kernel, stride, repeats in STAGES:
            for r in range(repeats):
                setattr(self, f"MBConv_{self.n_blocks}", MBConv(
                    cin, filters, expand, kernel, stride if r == 0 else 1))
                cin, self.n_blocks = filters, self.n_blocks + 1
        self.Conv_1 = ConvSame(cin, 192, 1)
        self.GroupNorm_1 = group_norm(192)
        self.Dense_0 = nn.Linear(192, num_classes)

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        # NCHW in memory (see models/resnet.py)
        x = x.permute(0, 3, 1, 2).contiguous()
        x = F.silu(self.GroupNorm_0(self.Conv_0(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"MBConv_{i}")(x)
        x = F.silu(self.GroupNorm_1(self.Conv_1(x)))
        return self.Dense_0(x.mean(dim=(2, 3)))
