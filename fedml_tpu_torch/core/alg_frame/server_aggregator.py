"""ServerAggregator ABC — server-side half of the algorithm frame (port of
``fedml_tpu.core.alg_frame.server_aggregator``).

Hook pipeline parity: ``on_before_aggregation`` → ``aggregate`` →
``on_after_aggregation`` → ``assess_contribution``.  All hooks take and
return lists of ``(num_samples, params)`` pairs, the params the port's
``{name: tensor}`` dicts.

What differs from the JAX module: the trust plugins inside the default
hooks (attack injection, FHE, defenses, global DP clipping and noise) and
the contribution assessors are not ported.  The default hooks are what
the JAX ones do with every plugin off: ``on_before_aggregation`` returns
the list and its positions, ``on_after_aggregation`` the aggregate, and
there is no assessor (``contribution_assessor_mgr`` is ``None``).  An
``args`` that enables a plugin raises by name
(:func:`~.client_trainer.refuse_trust_stack`).
"""

from __future__ import annotations

import abc
from typing import Any, List, Tuple

from .client_trainer import refuse_trust_stack


class ServerAggregator(abc.ABC):
    def __init__(self, model, args):
        refuse_trust_stack(args, type(self).__name__)
        self.model = model
        self.id = 0
        self.args = args
        self.eval_data = None
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
        return raw_client_model_or_grad_list, client_idxs

    @abc.abstractmethod
    def aggregate(self, raw_client_model_or_grad_list: List[Tuple[float, Any]]):
        ...

    def on_after_aggregation(self, aggregated_model_or_grad: Any) -> Any:
        return aggregated_model_or_grad

    def assess_contribution(self, client_idxs, model_list, aggregated_model,
                            val_fn):
        """No contribution assessor is ported: nothing to run."""

    @abc.abstractmethod
    def test(self, test_data, device, args):
        ...
