"""Reweighting and sign-based defenses (port of
``fedml_tpu.core.security.defense.reweighting``): ``foolsgold``
(cosine-similarity history reweighting), ``residual_based_reweighting``
(repeated-median z-score reweighting), ``robust_learning_rate``
(sign-agreement learning-rate flipping), ``slsgd`` (trimmed mean mixed
with the global model) and ``wbc`` (2-means keep-set).

``wbc`` is numpy on the host in the JAX package; here it runs the same
arithmetic on the updates' device.
"""

from __future__ import annotations

import torch

from . import register
from .common import (BaseDefense, median, stack_clients, tree_flatten_1d,
                     tree_unflatten_1d)


@register("foolsgold")
class FoolsGoldDefense(BaseDefense):
    """FoolsGold: sybils push similar updates; per-client learning rates
    are derated by the max pairwise cosine similarity of the clients'
    summed history (kept across rounds)."""

    def __init__(self, args):
        super().__init__(args)
        self._history = None

    def defend_on_aggregation(self, raw_list, base_agg=None, extra=None):
        vecs, w, template = stack_clients(raw_list)
        hist = vecs if self._history is None else self._history + vecs
        self._history = hist
        normed = hist / torch.clamp(
            torch.linalg.vector_norm(hist, dim=1, keepdim=True), min=1e-12)
        cs = normed @ normed.T
        cs = cs - torch.eye(cs.shape[0], dtype=cs.dtype, device=cs.device)
        maxcs = torch.max(cs, dim=1).values
        # pardoning and the logit rescale of the FoolsGold paper
        mc = torch.clamp(maxcs, 1e-6, 1 - 1e-6)
        wv = 1.0 - mc
        wv = wv / torch.max(wv)
        wv = torch.clamp(wv, 1e-6, 1 - 1e-6)
        wv = torch.clamp(torch.log(wv / (1 - wv)) / 4.0 + 0.5, 0.0, 1.0)
        agg = (wv * w / torch.sum(wv * w + 1e-12)) @ vecs
        return tree_unflatten_1d(agg, template)


@register("residual_based_reweighting")
class ResidualBasedReweightingDefense(BaseDefense):
    """Per coordinate, clients far from the median (in MAD units) are
    down-weighted; a client's weight is the mean of its per-coordinate
    weights."""

    def __init__(self, args):
        super().__init__(args)
        self.lmbd = float(getattr(args, "reweight_lambda", 2.0))

    def defend_on_aggregation(self, raw_list, base_agg=None, extra=None):
        vecs, w, template = stack_clients(raw_list)
        med = median(vecs, dim=0)
        mad = median(torch.abs(vecs - med[None, :]), dim=0) + 1e-12
        z = torch.abs(vecs - med[None, :]) / (1.4826 * mad[None, :])
        per_coord_w = torch.clamp(1.0 - z / self.lmbd, 0.0, 1.0)
        client_w = torch.mean(per_coord_w, dim=1) * w
        agg = (client_w / torch.sum(client_w)) @ vecs
        return tree_unflatten_1d(agg, template)


@register("robust_learning_rate")
class RobustLearningRateDefense(BaseDefense):
    """RLR: coordinates where fewer than θ clients agree on the update's
    sign get their learning rate flipped (the server applies −Δ there)."""

    def __init__(self, args):
        super().__init__(args)
        self.robust_threshold = int(getattr(args, "robust_threshold", 4))

    def defend_on_aggregation(self, raw_list, base_agg=None, extra=None):
        if extra is None:
            raise ValueError("robust_learning_rate needs the global model "
                             "via extra")
        vecs, w, template = stack_clients(raw_list)
        g = tree_flatten_1d(extra)
        deltas = vecs - g[None, :]
        sign_agree = torch.abs(torch.sum(torch.sign(deltas), dim=0))
        lr_sign = torch.where(sign_agree >= self.robust_threshold, 1.0, -1.0)
        mean_delta = (w / torch.sum(w)) @ deltas
        return tree_unflatten_1d(g + lr_sign * mean_delta, template)


@register("slsgd")
class SLSGDDefense(BaseDefense):
    """SLSGD: the trimmed-mean merge, then x⁺ = (1−α)·x + α·agg with the
    current global model x."""

    def __init__(self, args):
        super().__init__(args)
        self.alpha = float(getattr(args, "slsgd_alpha", 0.5))
        self.b = int(getattr(args, "trim_param_b", 1))

    def defend_on_aggregation(self, raw_list, base_agg=None, extra=None):
        vecs, w, template = stack_clients(raw_list)
        c = vecs.shape[0]
        b = min(self.b, (c - 1) // 2)
        s = torch.sort(vecs, dim=0).values
        agg = torch.mean(s[b: c - b] if c - 2 * b > 0 else s, dim=0)
        if extra is not None:
            g = tree_flatten_1d(extra)
            agg = (1 - self.alpha) * g + self.alpha * agg
        return tree_unflatten_1d(agg, template)


@register("wbc")
class WBCDefense(BaseDefense):
    """Weight-based clustering: 2-means over the client vectors, seeded
    with the two farthest-apart clients; keep the larger cluster."""

    def defend_before_aggregation(self, raw_list, extra=None):
        vecs, w, template = stack_clients(raw_list)
        v = vecs
        c = v.shape[0]
        if c < 3:
            return raw_list
        d2 = ((v[:, None, :] - v[None, :, :]) ** 2).sum(-1)
        flat = int(torch.argmax(d2))
        i, j = divmod(flat, c)
        assign = (d2[:, i] > d2[:, j]).tolist()   # False → cluster i
        for _ in range(5):
            a = torch.tensor(assign, device=v.device)
            mu0 = v[~a].mean(0) if not all(assign) else v[i]
            mu1 = v[a].mean(0) if any(assign) else v[j]
            assign = (((v - mu0) ** 2).sum(1)
                      > ((v - mu1) ** 2).sum(1)).tolist()
        ones = sum(assign)
        keep_cluster = 0 if c - ones >= ones else 1
        return [raw_list[k] for k in range(c)
                if int(assign[k]) == keep_cluster]
