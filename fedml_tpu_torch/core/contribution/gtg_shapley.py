"""GTG-Shapley contribution valuation (port of
``fedml_tpu.core.contribution.gtg_shapley``): guided truncated gradient
Shapley — truncated Monte-Carlo permutation sampling over client updates,
evaluating the marginal utility of each client's model in permutation
order, with within-round truncation.

The permutations are the JAX package's host streams (``hostrng``, tag
0x617); each utility is one merge and one ``val_fn`` on the models'
device.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from .. import hostrng
from ..tree import weighted_average


class GTGShapleyValue:
    def __init__(self, args):
        self.args = args
        self.eps = float(getattr(args, "gtg_eps", 1e-3))
        self.max_perms = int(getattr(args, "gtg_max_perms", 10))
        self.round_trunc = float(getattr(args, "gtg_round_trunc", 1e-3))
        self.seed = int(getattr(args, "random_seed", 0))

    def compute(self, client_idxs: List[int], model_list, aggregated_model,
                val_fn: Callable) -> Dict[int, float]:
        """model_list: [(n_k, params_k)]; val_fn(params) → utility scalar."""
        m = len(model_list)
        if aggregated_model is None:
            aggregated_model = weighted_average([p for _, p in model_list],
                                                [n for n, _ in model_list])
        v_init = float(val_fn(aggregated_model))
        phi = {c: 0.0 for c in client_idxs}
        rng = hostrng.gen(self.seed, 0x617)
        count = 0
        for t in range(self.max_perms):
            perm = rng.permutation(m)
            prev_u = 0.0
            prev_models: list = []
            for pos, j in enumerate(perm):
                prev_models.append(model_list[j])
                merged = weighted_average([p for _, p in prev_models],
                                          [n for n, _ in prev_models])
                u = float(val_fn(merged))
                phi[client_idxs[j]] += u - prev_u
                prev_u = u
                # within-round truncation: marginal gain negligible
                if abs(v_init - u) < self.eps and pos >= 1:
                    break
            count += 1
        return {c: v / max(count, 1) for c, v in phi.items()}
