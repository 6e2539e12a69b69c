"""Distance- and statistics-based robust aggregation (port of
``fedml_tpu.core.security.defense.robust_aggregation``): krum and
multi-krum, bulyan, the coordinate-wise median and trimmed mean, the
bucketed geometric median and RFA (the smoothed Weiszfeld geometric
median).

All math runs on the stacked ``(C, D)`` client matrix on the updates'
device; sorts are stable, as ``jnp.argsort``'s.  Krum and bulyan keep
their last scores and selection (``last_scores``, ``last_selected``) for
whoever wants to see a near tie.
"""

from __future__ import annotations

import torch

from . import register
from .common import (BaseDefense, median, pairwise_sq_dists, stack_clients,
                     tree_unflatten_1d)


def _krum_scores(vecs: torch.Tensor, f: int) -> torch.Tensor:
    """Each client's sum of squared distances to its ``C − f − 2`` nearest
    others."""
    c = vecs.shape[0]
    d2 = pairwise_sq_dists(vecs)
    d2.fill_diagonal_(float("inf"))
    k = max(c - f - 2, 1)
    return torch.sum(torch.sort(d2, dim=1).values[:, :k], dim=1)


@register("krum")
@register("multi_krum")
class KrumDefense(BaseDefense):
    """Krum/multi-Krum: score each client by the sum of its k nearest
    squared distances; keep the best 1 (krum) or m (multi-krum)."""

    def __init__(self, args):
        super().__init__(args)
        self.byzantine_client_num = int(getattr(args, "byzantine_client_num",
                                                1))
        self.multi = str(getattr(args, "defense_type",
                                 "krum")).lower() == "multi_krum"
        self.krum_param_m = int(getattr(args, "krum_param_m", 3)) \
            if self.multi else 1
        self.last_scores = None
        self.last_selected = None

    def defend_before_aggregation(self, raw_list, extra=None):
        c = len(raw_list)
        f = min(self.byzantine_client_num, max(c - 3, 0) // 2)
        vecs, w, template = stack_clients(raw_list)
        scores = _krum_scores(vecs, f)
        m = min(self.krum_param_m, c)
        keep = torch.argsort(scores, stable=True)[:m].tolist()
        self.last_scores, self.last_selected = scores, keep
        return [raw_list[int(i)] for i in keep]


@register("bulyan")
class BulyanDefense(BaseDefense):
    """Bulyan: multi-krum selection of θ = C − 2f clients, then the
    per-coordinate mean of the β = θ − 2f values closest to the coordinate
    median."""

    def __init__(self, args):
        super().__init__(args)
        self.f = int(getattr(args, "byzantine_client_num", 1))
        self.last_scores = None
        self.last_selected = None

    def defend_on_aggregation(self, raw_list, base_agg=None, extra=None):
        c = len(raw_list)
        f = min(self.f, max((c - 3) // 4, 0))
        theta = c - 2 * f
        vecs, w, template = stack_clients(raw_list)
        scores = _krum_scores(vecs, f)
        sel = torch.argsort(scores, stable=True)[:theta]
        self.last_scores, self.last_selected = scores, sel.tolist()
        sub = vecs[sel]                                   # (θ, D)
        med = median(sub, dim=0)                          # (D,)
        beta = max(theta - 2 * f, 1)
        dist = torch.abs(sub - med[None, :])
        order = torch.argsort(dist, dim=0, stable=True)[:beta]   # (β, D)
        out = torch.mean(torch.gather(sub, 0, order), dim=0)
        return tree_unflatten_1d(out, template)


@register("coordinate_wise_median")
@register("median")
class CoordinateWiseMedianDefense(BaseDefense):
    def defend_on_aggregation(self, raw_list, base_agg=None, extra=None):
        vecs, _, template = stack_clients(raw_list)
        return tree_unflatten_1d(median(vecs, dim=0), template)


@register("coordinate_wise_trimmed_mean")
@register("trimmed_mean")
class TrimmedMeanDefense(BaseDefense):
    def __init__(self, args):
        super().__init__(args)
        self.beta = float(getattr(args, "trimmed_mean_beta",
                                  getattr(args, "beta", 0.1)))

    def defend_on_aggregation(self, raw_list, base_agg=None, extra=None):
        vecs, _, template = stack_clients(raw_list)
        c = vecs.shape[0]
        k = int(self.beta * c)
        s = torch.sort(vecs, dim=0).values
        kept = s[k: c - k] if c - 2 * k > 0 else s
        return tree_unflatten_1d(torch.mean(kept, dim=0), template)


@register("geometric_median_bucket")
class GeometricMedianBucketDefense(BaseDefense):
    """Byzantine gradient descent (Chen et al. 2017): clients are grouped
    into ``batch_num`` buckets, each bucket is averaged by weight, and the
    geometric median of the bucket means is the aggregate.  Zero-weight
    padding keeps the buckets equal; an all-padding bucket never enters
    the median."""

    def __init__(self, args):
        super().__init__(args)
        f = int(getattr(args, "byzantine_client_num", 0))
        per_round = int(getattr(args, "client_num_per_round", 0))
        default = 1 if f == 0 else max(2 * f + 1, 3)
        self.batch_num = int(getattr(args, "batch_num", 0) or default)
        if per_round:
            self.batch_num = min(self.batch_num, per_round)
        self.iters = int(getattr(args, "rfa_iters", 8))

    def defend_on_aggregation(self, raw_list, base_agg=None, extra=None):
        vecs, w, template = stack_clients(raw_list)
        c, d = vecs.shape
        k = max(1, min(self.batch_num, c))
        size = -(-c // k)
        pad = k * size - c
        vp = torch.cat([vecs, vecs.new_zeros((pad, d))])
        wp = torch.cat([w, w.new_zeros((pad,))])
        vb = vp.reshape(k, size, d)
        wb = wp.reshape(k, size)
        wtot = torch.sum(wb, dim=1)                        # (k,)
        wsum = torch.clamp(wtot, min=1e-12)[:, None]
        means = torch.sum(vb * (wb / wsum)[..., None], dim=1)   # (k, D)
        valid = (wtot > 0).to(vecs.dtype)                  # (k,)
        v = (valid / torch.sum(valid)) @ means
        for _ in range(self.iters):
            dist = torch.sqrt(torch.sum((means - v[None, :]) ** 2, dim=1))
            beta = valid / torch.clamp(dist, min=1e-6)
            v = (beta / torch.sum(beta)) @ means
        return tree_unflatten_1d(v, template)


@register("rfa")
@register("geometric_median")
class RFADefense(BaseDefense):
    """RFA: the weighted geometric median by the smoothed Weiszfeld
    iteration, a fixed number of steps."""

    def __init__(self, args):
        super().__init__(args)
        self.iters = int(getattr(args, "rfa_iters", 8))
        self.eps = 1e-6

    def defend_on_aggregation(self, raw_list, base_agg=None, extra=None):
        vecs, w, template = stack_clients(raw_list)
        alphas = w / torch.sum(w)
        v = alphas @ vecs
        for _ in range(self.iters):
            dist = torch.sqrt(torch.sum((vecs - v[None, :]) ** 2, dim=1))
            beta = alphas / torch.clamp(dist, min=self.eps)
            beta = beta / torch.sum(beta)
            v = beta @ vecs
        return tree_unflatten_1d(v, template)
