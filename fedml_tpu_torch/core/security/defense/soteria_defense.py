"""Soteria (port of ``fedml_tpu.core.security.defense.soteria_defense``):
against gradient-inversion reconstruction, zero the smallest-|g| fraction
of the last 2-D leaf's update (the representation-revealing output
kernel), leaving the rest intact.  "Last" is in the JAX leaf order
(``common.layout_of``); the threshold is a sorted magnitude, the same in
either layout."""

from __future__ import annotations

import torch

from . import register
from .common import BaseDefense, layout_of


@register("soteria")
class SoteriaDefense(BaseDefense):
    def __init__(self, args):
        super().__init__(args)
        self.prune_ratio = float(getattr(args, "soteria_prune_ratio", 0.5))

    def _prune_last_dense(self, params):
        target = None
        for name, _ in layout_of(params):
            if params[name].ndim == 2:
                target = name
        out = dict(params)
        if target is not None:
            leaf = params[target]
            k = int(self.prune_ratio * leaf.numel())
            if k > 0:
                thresh = torch.sort(torch.abs(leaf.reshape(-1))).values[k - 1]
                out[target] = torch.where(torch.abs(leaf) <= thresh,
                                          torch.zeros_like(leaf), leaf)
        return out

    def defend_before_aggregation(self, raw_list, extra=None):
        return [(n, self._prune_last_dense(p)) for n, p in raw_list]
