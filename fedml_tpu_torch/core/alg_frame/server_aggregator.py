"""ServerAggregator ABC — server-side half of the algorithm frame (port of
``fedml_tpu.core.alg_frame.server_aggregator``).

Hook pipeline parity: ``on_before_aggregation`` → ``aggregate`` →
``on_after_aggregation`` → ``assess_contribution``.  All hooks take and
return lists of ``(num_samples, params)`` pairs, the params the port's
``{name: tensor}`` dicts.

The default hooks thread the trust plugins: ``on_before_aggregation``
injects the red-team model attack, then runs the defense's
before-aggregation pass and the global DP clip; ``on_after_aggregation``
runs the defense's after-aggregation pass and adds the global DP noise.

What differs from the JAX module: FHE and the contribution assessors are
not ported (``contribution_assessor_mgr`` is ``None``); an ``args`` that
enables one raises by name (:func:`~.client_trainer.refuse_trust_stack`).
"""

from __future__ import annotations

import abc
from typing import Any, List, Tuple

from ..dp.fedml_differential_privacy import FedMLDifferentialPrivacy
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
        self.contribution_assessor_mgr = None
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
        """No contribution assessor is ported: nothing to run."""

    @abc.abstractmethod
    def test(self, test_data, device, args):
        ...
