"""DP deployment frames (port of ``fedml_tpu.core.dp.frames``): local DP
(noise on each client update), global DP (the server clips the updates
and noises the aggregate) and NbAFL (both sides, Wei et al.)."""

from __future__ import annotations

import torch

from ...security.defense.common import tree_flatten_1d, tree_unflatten_1d
from ..mechanisms import create_mechanism


class _BaseFrame:
    def __init__(self, args):
        self.args = args
        self.mechanism = create_mechanism(args)
        self.clip_norm = float(getattr(args, "dp_clip_norm", 0.0))

    def is_clipping(self) -> bool:
        return self.clip_norm > 0

    def _clip(self, params):
        flat = tree_flatten_1d(params)
        norm = torch.linalg.vector_norm(flat)
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return tree_unflatten_1d(flat * scale, params)

    def global_clip(self, raw_client_list):
        if not self.is_clipping():
            return raw_client_list
        return [(n, self._clip(p)) for n, p in raw_client_list]

    def add_local_noise(self, local_grad, source):
        return local_grad

    def add_global_noise(self, global_model, source):
        return global_model


class LocalDP(_BaseFrame):
    """LDP: every client perturbs its own update."""

    def add_local_noise(self, local_grad, source):
        if self.is_clipping():
            local_grad = self._clip(local_grad)
        return self.mechanism.add_noise(local_grad, source)


class GlobalDP(_BaseFrame):
    """CDP: the server clips the client updates and noises the
    aggregate."""

    def add_global_noise(self, global_model, source):
        return self.mechanism.add_noise(global_model, source)


class NbAFL(_BaseFrame):
    """NbAFL: noise before (client side) and after (server side)
    aggregation."""

    def add_local_noise(self, local_grad, source):
        if self.is_clipping():
            local_grad = self._clip(local_grad)
        return self.mechanism.add_noise(local_grad, source)

    def add_global_noise(self, global_model, source):
        return self.mechanism.add_noise(global_model, source)


def create_dp_frame(solution_type: str, args):
    t = solution_type.strip().lower()
    if t == "local_dp":
        return LocalDP(args)
    if t == "global_dp":
        return GlobalDP(args)
    if t == "nbafl":
        return NbAFL(args)
    raise ValueError(f"unknown dp_solution_type {solution_type!r}")
