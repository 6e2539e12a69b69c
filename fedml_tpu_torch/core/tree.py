"""Helpers over flat ``{path: tensor}`` dicts — the port's stand-in for the
JAX package's pytree utilities (``fedml_tpu.core.tree``), limited to what
the federated LoRA round uses."""

from __future__ import annotations

from typing import Callable, Dict

import torch

TensorDict = Dict[str, torch.Tensor]


def tree_map(fn: Callable, tree: TensorDict, *rest: TensorDict) -> TensorDict:
    return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_zeros_like(tree: TensorDict) -> TensorDict:
    return tree_map(torch.zeros_like, tree)

