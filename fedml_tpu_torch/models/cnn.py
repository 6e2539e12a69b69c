"""CNNs of the reference model zoo (port of ``fedml_tpu.models.cnn``).

- ``CNNDropOut`` — the FedAvg-paper FEMNIST CNN: 2 × (conv 5×5 + maxpool),
  dense 128, dropout 0.25 and 0.5.
- ``CNNWeb`` — one conv 3×3 + maxpool + dense.
- ``CNNCifar`` — three convs 3×3, two maxpools, dense 128.

Inputs come in the dataset's NHWC layout (a 3-D batch gains a channel)
and the convolutions run in NCHW.  Before the first dense layer the
features are put back in H·W·C order, the order flax flattens in, so a
flax ``Dense`` kernel is this ``Linear``'s weight transposed.  Flax's
``SAME`` padding of an odd k×k kernel is ``padding=k//2``; the max-pools
are 2×2, stride 2, ``VALID``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .base import apply_dropout


def _nchw(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 3:
        x = x[..., None]
    return x.permute(0, 3, 1, 2)


def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(F.relu(x), 2, 2)


def _channels(input_shape) -> int:
    return int(input_shape[-1]) if len(input_shape) == 3 else 1


class CNNDropOut(nn.Module):
    DROPOUT = (0.25, 0.5)

    def __init__(self, input_shape: Tuple[int, ...], output_dim: int = 62,
                 only_digits: bool = False):
        super().__init__()
        h, w = input_shape[0], input_shape[1]
        self.Conv_0 = nn.Conv2d(_channels(input_shape), 32, 5, padding=2)
        self.Conv_1 = nn.Conv2d(32, 64, 5, padding=2)
        self.Dense_0 = nn.Linear(64 * (h // 4) * (w // 4), 128)
        self.Dense_1 = nn.Linear(128, 10 if only_digits else output_dim)

    def dropout_sites(self, input_shape):
        flat = 64 * (input_shape[0] // 4) * (input_shape[1] // 4)
        return (((flat,), self.DROPOUT[0]), ((128,), self.DROPOUT[1]))

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        m0, m1 = dropout_masks if dropout_masks is not None else (None, None)
        x = _pool(self.Conv_0(_nchw(x)))
        x = _pool(self.Conv_1(x))
        x = apply_dropout(_flatten_hwc(x), m0, self.DROPOUT[0])
        x = apply_dropout(F.relu(self.Dense_0(x)), m1, self.DROPOUT[1])
        return self.Dense_1(x)


class CNNWeb(nn.Module):
    def __init__(self, input_shape: Tuple[int, ...], output_dim: int = 10):
        super().__init__()
        h, w = input_shape[0], input_shape[1]
        self.Conv_0 = nn.Conv2d(_channels(input_shape), 16, 3, padding=1)
        self.Dense_0 = nn.Linear(16 * (h // 2) * (w // 2), output_dim)

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        return self.Dense_0(_flatten_hwc(_pool(self.Conv_0(_nchw(x)))))


class CNNCifar(nn.Module):
    def __init__(self, input_shape: Tuple[int, ...], output_dim: int = 10):
        super().__init__()
        h, w, c = input_shape
        self.Conv_0 = nn.Conv2d(c, 32, 3, padding=1)
        self.Conv_1 = nn.Conv2d(32, 64, 3, padding=1)
        self.Conv_2 = nn.Conv2d(64, 64, 3, padding=1)
        self.Dense_0 = nn.Linear(64 * (h // 4) * (w // 4), 128)
        self.Dense_1 = nn.Linear(128, output_dim)

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        x = F.relu(self.Conv_0(x.permute(0, 3, 1, 2)))
        x = _pool(self.Conv_1(x))
        x = _pool(self.Conv_2(x))
        x = F.relu(self.Dense_0(_flatten_hwc(x)))
        return self.Dense_1(x)
