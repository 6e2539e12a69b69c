"""Leave-one-out contribution valuation (port of
``fedml_tpu.core.contribution.loo``): φ_k = U(all) − U(all \\ k)."""

from __future__ import annotations

from typing import Callable, Dict, List

from ..tree import weighted_average


class LeaveOneOut:
    def __init__(self, args):
        self.args = args

    def compute(self, client_idxs: List[int], model_list, aggregated_model,
                val_fn: Callable) -> Dict[int, float]:
        if aggregated_model is None:
            aggregated_model = weighted_average([p for _, p in model_list],
                                                [n for n, _ in model_list])
        v_all = float(val_fn(aggregated_model))
        phi = {}
        for k in range(len(model_list)):
            rest = [model_list[i] for i in range(len(model_list)) if i != k]
            if not rest:
                phi[client_idxs[k]] = v_all
                continue
            merged = weighted_average([p for _, p in rest],
                                      [n for n, _ in rest])
            phi[client_idxs[k]] = v_all - float(val_fn(merged))
        return phi
