"""DARTS differentiable architecture search supernet (port of
``fedml_tpu.models.darts``): ``MixedOp``, ``Cell``, ``DARTSNetwork`` and
``derive_genotype``.

A MixedOp computes every candidate op, stacks the outputs and contracts
them with softmax(alpha) in one einsum, so the alpha gradient flows
through the contraction.  The architecture logits are the bare parameters
``alphas_normal``/``alphas_reduce`` of the network, ordinary entries of
the parameter dict, so FedNAS averages weights and architecture alike.

flax's ``"SAME"`` pooling is XLA's rule (``models/resnet.py::same_pads``):
at stride 2 on an even size it pads (0, 1), which ``avg_pool2d``'s
symmetric padding cannot express, so the pools pad explicitly — zeros
before the average pool (flax counts the padded zeros: the sum is divided
by 9 everywhere) and −inf before the max pool.  Inputs keep the dataset's
NHWC layout; the ops run in NCHW.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import ConvSame, group_norm, same_pads

PRIMITIVES = ("none", "skip_connect", "conv_3x3", "sep_conv_3x3",
              "avg_pool_3x3", "max_pool_3x3")


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float):
    (ht, hb), (wl, wr) = (same_pads(x.shape[-2], k, stride),
                          same_pads(x.shape[-1], k, stride))
    return F.pad(x, (wl, wr, ht, hb), value=value)


class _Op(nn.Module):
    def __init__(self, op_name: str, cin: int, channels: int,
                 stride: int = 1):
        super().__init__()
        self.op_name, self.stride = op_name, stride
        if op_name == "skip_connect" and stride > 1:
            self.Conv_0 = ConvSame(cin, channels, 1, stride)
        elif op_name == "conv_3x3":
            self.Conv_0 = ConvSame(cin, channels, 3, stride)
            self.GroupNorm_0 = group_norm(channels)
        elif op_name == "sep_conv_3x3":
            self.Conv_0 = ConvSame(cin, cin, 3, stride, groups=cin)
            self.Conv_1 = ConvSame(cin, channels, 1)
            self.GroupNorm_0 = group_norm(channels)
        elif op_name not in PRIMITIVES:
            raise ValueError(op_name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, name = self.stride, self.op_name
        if name == "none":
            # zeros at the strided shape (flax: a 1×1 pool, then zeros)
            return torch.zeros_like(x[:, :, ::s, ::s])
        if name == "skip_connect":
            return x if s == 1 else self.Conv_0(x)
        if name == "conv_3x3":
            return self.GroupNorm_0(self.Conv_0(F.relu(x)))
        if name == "sep_conv_3x3":
            return self.GroupNorm_0(self.Conv_1(self.Conv_0(F.relu(x))))
        if name == "avg_pool_3x3":
            return F.avg_pool2d(_pad_same(x, 3, s, 0.0), 3, s)
        return F.max_pool2d(_pad_same(x, 3, s, float("-inf")), 3, s)


class MixedOp(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1):
        super().__init__()
        self.n_ops = len(PRIMITIVES)
        for i, p in enumerate(PRIMITIVES):
            setattr(self, f"_Op_{i}", _Op(p, cin, channels, stride))

    def forward(self, x: torch.Tensor, weights: torch.Tensor):
        stacked = torch.stack([getattr(self, f"_Op_{i}")(x)
                               for i in range(self.n_ops)])
        return torch.einsum("o,obchw->bchw", weights, stacked)


class Cell(nn.Module):
    """``steps`` intermediate nodes, each summing mixed-op edges from every
    earlier state; the output concatenates the intermediate nodes.  In a
    reduction cell the edges from the input state run at stride 2."""

    def __init__(self, cin: int, channels: int, steps: int = 3,
                 reduction: bool = False):
        super().__init__()
        self.steps = steps
        self.Conv_0 = ConvSame(cin, channels, 1)
        e = 0
        for i in range(steps):
            for j in range(i + 1):
                stride = 2 if (reduction and j == 0) else 1
                setattr(self, f"MixedOp_{e}", MixedOp(channels, channels,
                                                      stride))
                e += 1

    @staticmethod
    def num_edges(steps: int = 3) -> int:
        return sum(1 + i for i in range(steps))

    def forward(self, x: torch.Tensor, alphas: torch.Tensor):
        weights = torch.softmax(alphas, dim=-1)
        states = [self.Conv_0(x)]
        e = 0
        for _ in range(self.steps):
            acc = 0.0
            for h in states:
                acc = acc + getattr(self, f"MixedOp_{e}")(h, weights[e])
                e += 1
            states.append(acc)
        return torch.cat(states[1:], dim=1)


class DARTSNetwork(nn.Module):
    """Supernet: stem → normal cell → reduction cell → mean over H, W →
    Dense.  ``params["alphas_normal"]`` is the architecture."""

    #: flax's ``nn.initializers.normal(1e-3)`` for the architecture logits
    normal_init_std = {"alphas_normal": 1e-3, "alphas_reduce": 1e-3}

    def __init__(self, num_classes: int = 10, channels: int = 16,
                 steps: int = 3, in_channels: int = 3):
        super().__init__()
        e = Cell.num_edges(steps)
        self.alphas_normal = nn.Parameter(torch.empty(e, len(PRIMITIVES)))
        self.alphas_reduce = nn.Parameter(torch.empty(e, len(PRIMITIVES)))
        self.Conv_0 = ConvSame(in_channels, channels, 3)
        self.GroupNorm_0 = group_norm(channels)
        self.Cell_0 = Cell(channels, channels, steps)
        self.Cell_1 = Cell(steps * channels, channels, steps, reduction=True)
        self.Dense_0 = nn.Linear(steps * channels, num_classes)

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).contiguous()
        x = self.GroupNorm_0(self.Conv_0(x))
        x = self.Cell_0(x, self.alphas_normal)
        x = self.Cell_1(x, self.alphas_reduce)
        return self.Dense_0(x.mean(dim=(2, 3)))


def derive_genotype(params: Dict[str, torch.Tensor]) -> dict:
    """The discrete architecture: per edge, the argmax primitive other than
    ``none``."""
    out = {}
    for key in ("alphas_normal", "alphas_reduce"):
        a = params[key].detach().clone()
        a[:, PRIMITIVES.index("none")] = float("-inf")
        out[key] = [PRIMITIVES[int(i)] for i in torch.argmax(a, dim=-1)]
    return out
