"""Linear models (port of ``fedml_tpu.models.linear``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LogisticRegression(nn.Module):
    """Logits of one dense layer over the flattened input."""

    def __init__(self, in_features: int, output_dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, output_dim)

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        return self.Dense_0(x.reshape(x.shape[0], -1))


class MLP(nn.Module):
    """Two-layer perceptron."""

    def __init__(self, in_features: int, hidden: int, output_dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden)
        self.Dense_1 = nn.Linear(hidden, output_dim)

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        x = F.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return self.Dense_1(x)
