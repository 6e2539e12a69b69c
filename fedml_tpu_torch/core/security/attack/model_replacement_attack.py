"""Model-replacement backdoor (port of
``fedml_tpu.core.security.attack.model_replacement_attack``): the attacker
scales its update by ~N/η so the aggregate is replaced by the attacker's
model (Bagdasaryan et al.)."""

from __future__ import annotations

from ...tree import tree_axpy, tree_sub, weighted_average


class ModelReplacementBackdoorAttack:
    def __init__(self, args):
        self.boost = float(getattr(args, "model_replacement_boost",
                                   getattr(args, "client_num_per_round", 10)))
        self._global = None

    def set_global_model(self, params):
        self._global = params

    def attack_model(self, model_params, sample_num):
        if self._global is None:
            return model_params
        # x_adv = G + boost · (L − G)
        delta = tree_sub(model_params, self._global)
        return tree_axpy(self.boost, delta, self._global)

    def attack_model_list(self, model_list):
        if not model_list:
            return model_list
        if self._global is None:
            # without an explicit global model, boost against the mean
            self._global = weighted_average([p for _, p in model_list],
                                            [n for n, _ in model_list])
        n, p = model_list[0]
        return [(n, self.attack_model(p, n))] + list(model_list[1:])
