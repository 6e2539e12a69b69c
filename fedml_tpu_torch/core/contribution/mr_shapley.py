"""Multi-round (MR) Shapley valuation (port of
``fedml_tpu.core.contribution.mr_shapley``): exact Shapley over the
round's client subset by full subset enumeration when small, falling back
to permutation sampling (the JAX package's host stream, tag 0x3737) when
the cohort exceeds ``mr_exact_limit``.  Each coalition's utility is one
merge and one ``val_fn`` on the models' device, cached by coalition."""

from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, List

from .. import hostrng
from ..tree import weighted_average


class MRShapleyValue:
    def __init__(self, args):
        self.exact_limit = int(getattr(args, "mr_exact_limit", 8))
        self.sample_perms = int(getattr(args, "mr_sample_perms", 20))
        self.seed = int(getattr(args, "random_seed", 0))

    def _u(self, subset, model_list, val_fn, cache):
        key = frozenset(subset)
        if key not in cache:
            if not subset:
                cache[key] = 0.0
            else:
                models = [model_list[i] for i in subset]
                merged = weighted_average([p for _, p in models],
                                          [n for n, _ in models])
                cache[key] = float(val_fn(merged))
        return cache[key]

    def compute(self, client_idxs: List[int], model_list, aggregated_model,
                val_fn: Callable) -> Dict[int, float]:
        m = len(model_list)
        cache: dict = {}
        phi = {c: 0.0 for c in client_idxs}
        if m <= self.exact_limit:
            for k in range(m):
                others = [i for i in range(m) if i != k]
                for r in range(m):
                    w = (math.factorial(r) * math.factorial(m - r - 1)
                         / math.factorial(m))
                    for S in itertools.combinations(others, r):
                        gain = (self._u(list(S) + [k], model_list, val_fn, cache)
                                - self._u(list(S), model_list, val_fn, cache))
                        phi[client_idxs[k]] += w * gain
            return phi
        rng = hostrng.gen(self.seed, 0x3737)
        for _ in range(self.sample_perms):
            perm = rng.permutation(m)
            cur: list = []
            prev_u = 0.0
            for j in perm:
                cur.append(int(j))
                u = self._u(cur, model_list, val_fn, cache)
                phi[client_idxs[int(j)]] += (u - prev_u) / self.sample_perms
                prev_u = u
        return phi
