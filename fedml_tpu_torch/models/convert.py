"""Weight carry-over between the JAX package's flax ``params`` trees and the
port's parameter dicts for the :mod:`model_hub` models.

Threefry draws cannot be reproduced in PyTorch, so parity runs start both
packages from the same weights.  The flax names are kept
(``Conv_0/kernel`` ↔ ``Conv_0.weight``); a ``Dense`` kernel ``(in, out)``
is a ``Linear`` weight ``(out, in)``, and a ``Conv`` kernel HWIO is a
``Conv2d`` weight OIHW.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..core.tree import flatten, unflatten
from .base import TorchModel


def _to_port(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr


def _to_flax(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    return arr


def from_flax(params_np: Mapping, model: TorchModel,
              device="cuda") -> Dict[str, torch.Tensor]:
    """flax ``params`` tree → the port's f32 parameter dict on ``device``.
    Every parameter of ``model`` must be present with its shape."""
    flat = flatten(params_np)
    out = {}
    for name, p in model.module.named_parameters():
        layer, kind = name.split(".")
        key = f"{layer}/{'bias' if kind == 'bias' else 'kernel'}"
        arr = _to_port(np.asarray(flat.pop(key), np.float32))
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{key}: flax shape {arr.shape} is not the "
                             f"port's {tuple(p.shape)} transposed")
        out[name] = torch.tensor(np.ascontiguousarray(arr), device=device)
    if flat:
        raise ValueError(f"flax params not in the port's model: "
                         f"{sorted(flat)[:5]}")
    return out


def to_flax(params: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`from_flax`: a nested dict of f32 numpy arrays."""
    flat = {}
    for name, t in params.items():
        layer, kind = name.split(".")
        key = f"{layer}/{'bias' if kind == 'bias' else 'kernel'}"
        flat[key] = np.ascontiguousarray(
            _to_flax(t.detach().float().cpu().numpy()))
    return unflatten(flat)
