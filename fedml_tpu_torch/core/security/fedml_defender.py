"""Defense orchestrator singleton (port of
``fedml_tpu.core.security.fedml_defender``).

Exposes the three-phase surface the server aggregator calls:
``defend_before_aggregation`` (filter or reweight the raw client list),
``is_defense_on_aggregation``/``defend_on_aggregation`` (replace the
merge), ``defend_after_aggregation`` (post-process the global model).
Every defense works on the clients stacked into one ``(C, D)`` matrix on
the updates' device.
"""

from __future__ import annotations


class FedMLDefender:
    _instance = None

    @classmethod
    def get_instance(cls) -> "FedMLDefender":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self):
        self.is_enabled = False
        self.defense_type = None
        self.defender = None

    def init(self, args):
        # reset first, so a later run without the flag in the same process
        # does not inherit the previous run's defender
        self.is_enabled = False
        self.defense_type = None
        self.defender = None
        if args is None or not getattr(args, "enable_defense", False):
            return
        self.is_enabled = True
        self.defense_type = str(getattr(args, "defense_type",
                                        "")).strip().lower()
        from .defense import create_defender

        self.defender = create_defender(self.defense_type, args)

    def is_defense_enabled(self) -> bool:
        return self.is_enabled and self.defender is not None

    def defend(self, raw_client_grad_list, base_aggregation_func=None,
               extra_auxiliary_info=None):
        return self.defender.run(raw_client_grad_list, base_aggregation_func,
                                 extra_auxiliary_info)

    def is_defense_before_aggregation(self) -> bool:
        return self.is_defense_enabled() and hasattr(
            self.defender, "defend_before_aggregation")

    def is_defense_on_aggregation(self) -> bool:
        return self.is_defense_enabled() and hasattr(
            self.defender, "defend_on_aggregation")

    def is_defense_after_aggregation(self) -> bool:
        return self.is_defense_enabled() and hasattr(
            self.defender, "defend_after_aggregation")

    def defend_before_aggregation(self, raw_client_grad_list,
                                  extra_auxiliary_info=None):
        if self.is_defense_before_aggregation():
            return self.defender.defend_before_aggregation(
                raw_client_grad_list, extra_auxiliary_info)
        return raw_client_grad_list

    def defend_on_aggregation(self, raw_client_grad_list,
                              base_aggregation_func=None,
                              extra_auxiliary_info=None):
        if self.is_defense_on_aggregation():
            return self.defender.defend_on_aggregation(
                raw_client_grad_list, base_aggregation_func,
                extra_auxiliary_info)
        return base_aggregation_func(raw_client_grad_list)

    def defend_after_aggregation(self, global_model):
        if self.is_defense_after_aggregation():
            return self.defender.defend_after_aggregation(global_model)
        return global_model
