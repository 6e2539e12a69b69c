"""Outlier-score defenses (port of
``fedml_tpu.core.security.defense.outlier``): the robust 3σ family (drop
clients whose score exceeds the median by three MAD-sigmas: distance to
the coordinate median, to the geometric median, the krum score, or the
max cosine similarity), ``cross_round`` (flag clients whose update turns
against their own previous one) and ``outlier_detection`` (the cross-round
tripwire, then the 3σ filter only when it fired).
"""

from __future__ import annotations

import torch

from . import register
from .common import BaseDefense, kept, median, stack_clients
from .robust_aggregation import _krum_scores


def _three_sigma_keep(scores: torch.Tensor) -> torch.Tensor:
    """Robust 3σ rule: median/MAD instead of mean/std, so the outliers
    being tested cannot inflate the threshold that is to catch them."""
    med = median(scores)
    mad = median(torch.abs(scores - med))
    sigma = 1.4826 * mad + 1e-8 * (1.0 + torch.abs(med))
    return scores <= med + 3.0 * sigma


@register("three_sigma")
class ThreeSigmaDefense(BaseDefense):
    """Score = distance to the coordinate-wise median."""

    def defend_before_aggregation(self, raw_list, extra=None):
        vecs, w, template = stack_clients(raw_list)
        center = median(vecs, dim=0)
        scores = torch.linalg.vector_norm(vecs - center[None, :], dim=1)
        return kept(raw_list, _three_sigma_keep(scores)) or raw_list


@register("three_sigma_geomedian")
class ThreeSigmaGeoMedianDefense(BaseDefense):
    """Score = distance to the geometric median (5 Weiszfeld steps)."""

    def defend_before_aggregation(self, raw_list, extra=None):
        vecs, w, template = stack_clients(raw_list)
        v = torch.mean(vecs, dim=0)
        for _ in range(5):
            d = torch.linalg.vector_norm(vecs - v[None, :], dim=1)
            beta = 1.0 / torch.clamp(d, min=1e-6)
            v = (beta / torch.sum(beta)) @ vecs
        scores = torch.linalg.vector_norm(vecs - v[None, :], dim=1)
        return kept(raw_list, _three_sigma_keep(scores)) or raw_list


@register("three_sigma_krum")
class ThreeSigmaKrumDefense(BaseDefense):
    """Score = the krum score (sum of the k nearest squared distances)."""

    def __init__(self, args):
        super().__init__(args)
        self.f = int(getattr(args, "byzantine_client_num", 1))

    def defend_before_aggregation(self, raw_list, extra=None):
        vecs, w, template = stack_clients(raw_list)
        scores = _krum_scores(vecs, self.f)
        return kept(raw_list, _three_sigma_keep(scores)) or raw_list


@register("three_sigma_foolsgold")
class ThreeSigmaFoolsGoldDefense(BaseDefense):
    """Score = the max pairwise cosine similarity: a sybil coalition
    pushing aligned updates scores high together and falls past the 3σ
    gate, where the distance-based variants can miss colluders near the
    center."""

    def defend_before_aggregation(self, raw_list, extra=None):
        vecs, w, template = stack_clients(raw_list)
        normed = vecs / torch.clamp(
            torch.linalg.vector_norm(vecs, dim=1, keepdim=True), min=1e-12)
        cs = normed @ normed.T - torch.eye(vecs.shape[0], dtype=vecs.dtype,
                                           device=vecs.device)
        scores = torch.max(cs, dim=1).values
        return kept(raw_list, _three_sigma_keep(scores)) or raw_list


@register("outlier_detection")
class OutlierDetectionDefense(BaseDefense):
    """Two phases: the cross-round direction check runs every round as a
    tripwire; the 3σ filter engages only when the tripwire flagged a
    client."""

    def __init__(self, args):
        super().__init__(args)
        self.cross_round = CrossRoundDefense(args)
        self.three_sigma = ThreeSigmaDefense(args)

    def defend_before_aggregation(self, raw_list, extra=None):
        self.cross_round.defend_before_aggregation(raw_list, extra)
        # the flag list, not the returned length: when every client is
        # flagged the cross-round pass falls back to the whole list
        if not self.cross_round.last_flagged:
            return raw_list
        return self.three_sigma.defend_before_aggregation(raw_list, extra)


@register("cross_round")
class CrossRoundDefense(BaseDefense):
    """Track each client position's previous update; a cosine similarity
    below the threshold with its own history marks it this round."""

    def __init__(self, args):
        super().__init__(args)
        self.threshold = float(getattr(args, "cross_round_threshold", -0.2))
        self._prev = {}
        self.last_flagged: list = []  # positions flagged in the last call

    def defend_before_aggregation(self, raw_list, extra=None):
        vecs, w, template = stack_clients(raw_list)
        prevs = [self._prev.get(i) for i in range(len(raw_list))]
        seen = [i for i, p in enumerate(prevs) if p is not None]
        ok = [True] * len(raw_list)
        if seen:
            v = vecs[seen]
            p = torch.stack([prevs[i] for i in seen])
            cos = torch.sum(v * p, dim=1) / (
                torch.linalg.vector_norm(v, dim=1)
                * torch.linalg.vector_norm(p, dim=1) + 1e-12)
            for i, good in zip(seen, (cos >= self.threshold).tolist()):
                ok[i] = good
        for i in range(len(raw_list)):
            self._prev[i] = vecs[i]
        self.last_flagged = [i for i in range(len(raw_list)) if not ok[i]]
        return [raw_list[i] for i in range(len(raw_list)) if ok[i]] \
            or raw_list
