"""Weight carry-over between the JAX package's flax ``params`` trees and the
port's parameter dicts for the :mod:`model_hub` models.

Threefry draws cannot be reproduced in PyTorch, so parity runs start both
packages from the same weights.  The flax names are kept, nested modules
included (``Conv_0/kernel`` ↔ ``Conv_0.weight``, ``layer_0/wq/kernel`` ↔
``layer_0.wq.weight``); :func:`~fedml_tpu_torch.models.base.param_kinds`
maps each parameter to its flax path.  A ``Dense`` kernel ``(in, out)``
is a ``Linear`` weight ``(out, in)``, a ``Conv`` kernel HWIO is a
``Conv2d`` weight OIHW; an ``Embed`` table, a norm ``scale`` and a bare
param (``pos_embed``) keep their layout.

A ``ConvTranspose`` kernel (flax's default ``transpose_kernel=False``) is
HWIO too, but flax convolves the stride-dilated input with the kernel as
stored, while ``ConvTranspose2d`` is the gradient of a convolution, which
convolves with the kernel flipped in both spatial dims and in/out swapped.
So its ``(in, out, kh, kw)`` weight is the kernel flipped in H and W and
transposed.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..core.tree import flatten, unflatten
from .base import TorchModel, param_kinds


def _to_port(arr: np.ndarray, kind: str, lead: int = 0) -> np.ndarray:
    """A leaf in flax's layout → the port's, over its trailing axes
    (``lead`` leading axes kept, as a per-client table's rows)."""
    ax = list(range(lead))
    if kind == "dense":
        return np.swapaxes(arr, -1, -2)
    if kind == "conv":
        return arr.transpose(ax + [lead + 3, lead + 2, lead, lead + 1])
    if kind == "conv_transpose":
        return np.flip(arr, axis=(lead, lead + 1)).transpose(
            ax + [lead + 2, lead + 3, lead, lead + 1])
    return arr


def _to_flax(arr: np.ndarray, kind: str, lead: int = 0) -> np.ndarray:
    """Inverse of :func:`_to_port`."""
    ax = list(range(lead))
    if kind == "dense":
        return np.swapaxes(arr, -1, -2)
    if kind == "conv":
        return arr.transpose(ax + [lead + 2, lead + 3, lead + 1, lead])
    if kind == "conv_transpose":
        return np.flip(arr.transpose(
            ax + [lead + 2, lead + 3, lead, lead + 1]), axis=(lead, lead + 1))
    return arr


def from_flax(params_np: Mapping, model: TorchModel,
              device="cuda") -> Dict[str, torch.Tensor]:
    """flax ``params`` tree → the port's f32 parameter dict on ``device``.
    Every parameter of ``model`` must be present with its shape."""
    flat = flatten(params_np)
    out = {}
    for name, (kind, key, _) in param_kinds(model.module).items():
        if key not in flat:
            raise ValueError(f"{key}: missing from the flax params")
        arr = _to_port(np.asarray(flat.pop(key), np.float32), kind)
        want = tuple(model.module.get_parameter(name).shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: flax shape {arr.shape} is not the "
                             f"port's {want} in flax's layout")
        out[name] = torch.tensor(np.ascontiguousarray(arr), device=device)
    if flat:
        raise ValueError(f"flax params not in the port's model: "
                         f"{sorted(flat)[:5]}")
    return out


def to_flax(params: Mapping[str, torch.Tensor], model: TorchModel) -> dict:
    """Inverse of :func:`from_flax`: a nested dict of f32 numpy arrays."""
    kinds = param_kinds(model.module)
    flat = {}
    for name, t in params.items():
        kind, key, _ = kinds[name]
        flat[key] = np.ascontiguousarray(
            _to_flax(t.detach().float().cpu().numpy(), kind))
    return unflatten(flat)
