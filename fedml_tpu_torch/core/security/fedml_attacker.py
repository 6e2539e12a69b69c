"""Attack orchestrator singleton (port of
``fedml_tpu.core.security.fedml_attacker``).

Config-gated: ``enable_attack`` + ``attack_type`` turns on one attack
plugin for red-team runs.  Model attacks map client params dicts to
params dicts on their device; data poisoning maps ``(x, y)`` host arrays.

What differs from the JAX module: :meth:`FedMLAttacker.init` resets the
singleton first, as the defender and DP singletons do.  The JAX ``init``
returns early without resetting, so a later run in the same process
without ``enable_attack`` keeps the previous run's attacker (a
process-state hazard of the reference, recorded in ``ROADMAP.md``).
"""

from __future__ import annotations

from typing import List, Tuple

_DATA_POISONING = {"label_flipping", "backdoor", "edge_case_backdoor"}
_MODEL_ATTACKS = {"byzantine", "model_replacement", "lazy_worker",
                  "random_mode"}
_RECON_ATTACKS = {"dlg", "invert_gradient", "revealing_labels"}


class FedMLAttacker:
    _instance = None

    @classmethod
    def get_instance(cls) -> "FedMLAttacker":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self):
        self.is_enabled = False
        self.attack_type = None
        self.attacker = None
        self.args = None

    def init(self, args):
        self.is_enabled = False
        self.attack_type = None
        self.attacker = None
        self.args = None
        if args is None or not getattr(args, "enable_attack", False):
            return
        self.is_enabled = True
        self.args = args
        self.attack_type = str(getattr(args, "attack_type",
                                       "")).strip().lower()
        from .attack import create_attacker

        self.attacker = create_attacker(self.attack_type, args)

    def provide_edge_pool(self, dataset):
        """Hand the attacker the dataset's edge-example pool when both
        exist (a dataset with ``edge_x``/``edge_y``)."""
        if (self.is_enabled and self.attacker is not None
                and hasattr(self.attacker, "set_edge_pool")
                and getattr(dataset, "edge_x", None) is not None):
            self.attacker.set_edge_pool(dataset.edge_x,
                                        getattr(dataset, "edge_y", None))

    # -- predicates ----------------------------------------------------------
    def is_data_poisoning_attack(self) -> bool:
        return self.is_enabled and self.attack_type in _DATA_POISONING

    def is_model_attack(self) -> bool:
        return self.is_enabled and self.attack_type in _MODEL_ATTACKS

    def is_reconstruct_data_attack(self) -> bool:
        return self.is_enabled and self.attack_type in _RECON_ATTACKS

    def is_to_poison_data(self) -> bool:
        return self.is_enabled and self.attacker is not None and \
            getattr(self.attacker, "active_this_round", lambda: True)()

    def is_server_sim_attack(self) -> bool:
        """Simulation mode injects model attacks server-side over the
        collected client list (``ServerAggregator.on_before_aggregation``)."""
        return True

    # -- actions ---------------------------------------------------------------
    def poison_data(self, dataset):
        return self.attacker.poison_data(dataset)

    def attack_model(self, model_params, sample_num):
        return self.attacker.attack_model(model_params, sample_num)

    def attack_model_list(self, model_list: List[Tuple[float, object]]):
        return self.attacker.attack_model_list(model_list)

    def reconstruct_data(self, a_gradient, extra_auxiliary_info=None):
        return self.attacker.reconstruct_data(a_gradient,
                                              extra_auxiliary_info)
