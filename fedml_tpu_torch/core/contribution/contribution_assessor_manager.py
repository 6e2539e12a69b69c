"""Contribution assessment manager (port of
``fedml_tpu.core.contribution.contribution_assessor_manager``).

Runs per round from ``ServerAggregator.assess_contribution``; dispatches
on ``contribution_alg`` (GTG-Shapley / MR-Shapley / leave-one-out).  The
assessors' loops and permutations run on the host; every coalition's merge
(``core/tree.py::weighted_average``) and the utility ``val_fn`` run on the
device of the models.
"""

from __future__ import annotations

from typing import Callable, Dict, List


class ContributionAssessorManager:
    def __init__(self, args):
        self.args = args
        self.alg = None
        if getattr(args, "enable_contribution", False):
            name = str(getattr(args, "contribution_alg", "GTG")).strip().lower()
            self.alg = self._build(name)

    def _build(self, name: str):
        from .gtg_shapley import GTGShapleyValue
        from .loo import LeaveOneOut
        from .mr_shapley import MRShapleyValue

        table = {"gtg": GTGShapleyValue, "mr": MRShapleyValue, "loo": LeaveOneOut}
        if name not in table:
            raise ValueError(f"unknown contribution_alg {name!r}; choose {list(table)}")
        return table[name](self.args)

    def get_assessor(self):
        return self.alg

    def run(self, client_idxs: List[int], model_list, aggregated_model,
            val_fn: Callable, out: Dict[int, float]):
        if self.alg is None:
            return
        shapley = self.alg.compute(client_idxs, model_list, aggregated_model, val_fn)
        for cid, v in shapley.items():
            out[cid] = out.get(cid, 0.0) + v
