"""Helpers over flat ``{path: tensor}`` dicts — the port's stand-in for the
JAX package's pytree utilities (``fedml_tpu.core.tree``), limited to what
the ported rounds use."""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch

TensorDict = Dict[str, torch.Tensor]


def tree_map(fn: Callable, tree: TensorDict, *rest: TensorDict) -> TensorDict:
    return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_zeros_like(tree: TensorDict) -> TensorDict:
    return tree_map(torch.zeros_like, tree)


def tree_stack(trees) -> TensorDict:
    """Stack identically-keyed dicts along a new leading axis."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def stacked_weighted_average(stacked: TensorDict, weights) -> TensorDict:
    """Weighted average over the leading (client) axis of a stacked dict:
    the weights are normalised, then one f32 ``tensordot`` per leaf."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    w = w / torch.sum(w)
    return tree_map(lambda leaf: torch.tensordot(
        w, leaf.to(torch.float32), dims=1).to(leaf.dtype), stacked)


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested dict → ``{"a/b/c": leaf}``."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def unflatten(flat: Mapping) -> dict:
    """Inverse of :func:`flatten`."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out
