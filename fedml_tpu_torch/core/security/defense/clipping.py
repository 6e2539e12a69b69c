"""Norm-clipping defenses (port of
``fedml_tpu.core.security.defense.clipping``): ``norm_diff_clipping``
(clip each update's delta to a ball around the global model), ``cclip``
(centered clipping around the previous aggregate), ``weak_dp`` (clip, then
Gaussian noise on the aggregate) and ``crfl`` (clip the aggregate's norm,
then Gaussian noise).

The noise is drawn on the aggregate's device through
:func:`fedml_tpu_torch.core.noise.draw` (``weak_dp`` and ``crfl``
purposes), one ``(D,)`` draw a round, as the JAX package draws one.
"""

from __future__ import annotations

import torch

from ... import noise
from . import register
from .common import (BaseDefense, stack_clients, tree_flatten_1d,
                     tree_unflatten_1d)


def _clip_to_ball(delta_vec: torch.Tensor, max_norm: float) -> torch.Tensor:
    norm = torch.linalg.vector_norm(delta_vec)
    return delta_vec * torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                                   max=1.0)


@register("norm_diff_clipping")
class NormDiffClippingDefense(BaseDefense):
    def __init__(self, args):
        super().__init__(args)
        self.norm_bound = float(getattr(args, "norm_bound", 5.0))

    def defend_before_aggregation(self, raw_list, extra=None):
        """``extra``: the global model (params dict) the deltas are taken
        against."""
        global_vec = tree_flatten_1d(extra) if extra is not None else 0.0
        out = []
        for n, p in raw_list:
            v = tree_flatten_1d(p)
            clipped = global_vec + _clip_to_ball(v - global_vec,
                                                 self.norm_bound)
            out.append((n, tree_unflatten_1d(clipped, p)))
        return out


@register("cclip")
class CClipDefense(BaseDefense):
    """Centered clipping (Karimireddy et al.); the center is the previous
    aggregate, kept across rounds."""

    def __init__(self, args):
        super().__init__(args)
        self.tau = float(getattr(args, "cclip_tau", 10.0))
        self.iters = int(getattr(args, "cclip_iters", 3))
        self._center = None

    def defend_on_aggregation(self, raw_list, base_agg=None, extra=None):
        vecs, w, template = stack_clients(raw_list)
        v = (tree_flatten_1d(self._center) if self._center is not None
             else vecs.new_zeros(vecs.shape[1]))
        alphas = w / torch.sum(w)
        for _ in range(self.iters):
            delta = vecs - v[None, :]
            norms = torch.linalg.vector_norm(delta, dim=1)
            scale = torch.clamp(self.tau / torch.clamp(norms, min=1e-12),
                                max=1.0)
            v = v + (alphas * scale) @ delta
        out = tree_unflatten_1d(v, template)
        self._center = out
        return out


@register("weak_dp")
class WeakDPDefense(BaseDefense):
    """Clip each update, then add small Gaussian noise to the
    aggregate."""

    def __init__(self, args):
        super().__init__(args)
        self.norm_bound = float(getattr(args, "norm_bound", 5.0))
        self.stddev = float(getattr(args, "weak_dp_stddev", 0.002))
        self._noise = noise.NoiseSource(
            "weak_dp", int(getattr(args, "random_seed", 0)))

    def defend_before_aggregation(self, raw_list, extra=None):
        return NormDiffClippingDefense(self.args).defend_before_aggregation(
            raw_list, extra)

    def defend_after_aggregation(self, global_model):
        flat = tree_flatten_1d(global_model)
        z = noise.draw(self._noise, flat.shape, flat.device)
        return tree_unflatten_1d(flat + self.stddev * z, global_model)


@register("crfl")
class CRFLDefense(BaseDefense):
    """CRFL: clip the aggregated model's norm and perturb it with Gaussian
    noise (certified robustness against backdoors)."""

    def __init__(self, args):
        super().__init__(args)
        self.clip_threshold = float(getattr(args, "crfl_clip", 15.0))
        self.stddev = float(getattr(args, "crfl_stddev", 0.01))
        self._noise = noise.NoiseSource(
            "crfl", int(getattr(args, "random_seed", 0)))

    def defend_after_aggregation(self, global_model):
        flat = _clip_to_ball(tree_flatten_1d(global_model),
                             self.clip_threshold)
        z = noise.draw(self._noise, flat.shape, flat.device)
        return tree_unflatten_1d(flat + self.stddev * z, global_model)
