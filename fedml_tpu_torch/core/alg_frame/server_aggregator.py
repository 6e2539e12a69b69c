"""ServerAggregator ABC — server-side half of the algorithm frame (port of
``fedml_tpu.core.alg_frame.server_aggregator``).

Hook pipeline parity: ``on_before_aggregation`` → ``aggregate`` →
``on_after_aggregation`` → ``assess_contribution``.  All hooks take and
return lists of ``(num_samples, params)`` pairs, the params the port's
``{name: tensor}`` dicts.

The default hooks thread the trust plugins: ``on_before_aggregation``
injects the red-team model attack, then either passes the (encrypted)
list through under FHE or runs the defense's before-aggregation pass and
the global DP clip; ``on_after_aggregation`` decrypts under FHE, or runs
the defense's after-aggregation pass and adds the global DP noise;
``assess_contribution`` runs the contribution assessor
(``contribution_alg``) when ``enable_contribution`` is on.

What differs from the JAX module: an ``args`` that enables upload
compression raises by name (:func:`~.client_trainer.refuse_trust_stack`).
"""

from __future__ import annotations

import abc
from typing import Any, List, Tuple

from ..contribution.contribution_assessor_manager import \
    ContributionAssessorManager
from ..dp.fedml_differential_privacy import FedMLDifferentialPrivacy
from ..fhe.fhe_agg import FedMLFHE
from ..security.defense.common import use_layout
from ..security.fedml_attacker import FedMLAttacker
from ..security.fedml_defender import FedMLDefender
from .client_trainer import refuse_trust_stack


class ServerAggregator(abc.ABC):
    def __init__(self, model, args):
        refuse_trust_stack(args, type(self).__name__)
        self.model = model
        self.id = 0
        self.args = args
        self.eval_data = None
        use_layout(model)
        FedMLAttacker.get_instance().init(args)
        FedMLDefender.get_instance().init(args)
        FedMLDifferentialPrivacy.get_instance().init(args)
        FedMLFHE.get_instance().init(args)
        self.contribution_assessor_mgr = ContributionAssessorManager(args)
        self.final_contribution_assigned_by_group = {}

    def set_id(self, aggregator_id):
        self.id = aggregator_id

    @abc.abstractmethod
    def get_model_params(self):
        ...

    @abc.abstractmethod
    def set_model_params(self, model_parameters):
        ...

    def on_before_aggregation(
        self, raw_client_model_or_grad_list: List[Tuple[float, Any]]
    ):
        client_idxs = list(range(len(raw_client_model_or_grad_list)))
        atk = FedMLAttacker.get_instance()
        if atk.is_model_attack() and atk.is_server_sim_attack():
            raw_client_model_or_grad_list = atk.attack_model_list(
                raw_client_model_or_grad_list)
        if FedMLFHE.get_instance().is_fhe_enabled():
            return raw_client_model_or_grad_list, client_idxs
        defender = FedMLDefender.get_instance()
        if defender.is_defense_enabled():
            raw_client_model_or_grad_list = \
                defender.defend_before_aggregation(
                    raw_client_model_or_grad_list, self.get_model_params())
        dp = FedMLDifferentialPrivacy.get_instance()
        if dp.is_global_dp_enabled() and dp.is_clipping():
            raw_client_model_or_grad_list = dp.global_clip(
                raw_client_model_or_grad_list)
        return raw_client_model_or_grad_list, client_idxs

    @abc.abstractmethod
    def aggregate(self, raw_client_model_or_grad_list: List[Tuple[float, Any]]):
        ...

    def on_after_aggregation(self, aggregated_model_or_grad: Any) -> Any:
        if FedMLFHE.get_instance().is_fhe_enabled():
            return FedMLFHE.get_instance().fhe_dec("global",
                                                   aggregated_model_or_grad)
        defender = FedMLDefender.get_instance()
        if defender.is_defense_enabled():
            aggregated_model_or_grad = defender.defend_after_aggregation(
                aggregated_model_or_grad)
        dp = FedMLDifferentialPrivacy.get_instance()
        if dp.is_global_dp_enabled():
            aggregated_model_or_grad = dp.add_global_noise(
                aggregated_model_or_grad)
        return aggregated_model_or_grad

    def assess_contribution(self, client_idxs, model_list, aggregated_model,
                            val_fn):
        """Credit each client of ``client_idxs`` its contribution to the
        round (``model_list``: its ``(num_samples, params)`` pairs) into
        ``final_contribution_assigned_by_group``, by the assessor of
        ``contribution_alg``; ``val_fn(params)`` is the utility."""
        if self.contribution_assessor_mgr is None:
            return
        self.contribution_assessor_mgr.run(
            client_idxs, model_list, aggregated_model, val_fn,
            self.final_contribution_assigned_by_group)

    @abc.abstractmethod
    def test(self, test_data, device, args):
        ...
