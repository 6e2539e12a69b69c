"""Cross-silo server aggregator (port of
``fedml_tpu.cross_silo.server.fedml_aggregator``).

Buffers client updates per round (flag-array ``check_whether_all_receive``
semantics), then runs the same server optimizer the simulators use
(``ServerOptimizer.update`` on the stacked client params and their sample
counts) inside the trust stack's hook pipeline — defend before
aggregation → global DP clip → either the defense's own merge or the
server optimizer → defend after aggregation → global DP noise — or a user
``ServerAggregator``'s (``on_before_aggregation`` → ``aggregate`` →
``on_after_aggregation``).  Silo partials
(``add_local_partial_aggregate``) combine exactly through
``federated.combine_partial_aggregates``.

With a user ``ServerAggregator`` whose contribution assessor is on, the
round ends with ``assess_contribution``: each coalition's merge and its
utility — the server trainer's accuracy on ``dataset.test_batches()`` —
on ``device``.

What differs from the JAX module: the state lives on ``device`` (the card
unless the CPU is asked for), uploads that arrive as host arrays are moved
there, and the defenses and DP run on it; ``assess_contribution`` gets the
round's ``(num_samples, params)`` pairs, which the assessors merge by —
the JAX aggregator passes the params alone, and its assessors then fail
to unpack them (a recorded divergence).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import torch

from ...core import federated
from ...core import rng as rng_util
from ...core import tree as tree_util
from ...core.alg_frame.client_trainer import refuse_trust_stack
from ...core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
from ...core.security.defense.common import use_layout
from ...core.security.fedml_defender import FedMLDefender
from ...core.wire import tensor_tree
from ...ml.aggregator.agg_operator import ServerOptimizer
from ...ml.trainer.local_trainer import LocalTrainer

log = logging.getLogger(__name__)


class FedMLAggregator:
    def __init__(self, args, model, dataset, client_num: int, device=None):
        from ...device import get_device

        refuse_trust_stack(args, "FedMLAggregator")
        self.args = args
        self.model = model
        self.dataset = dataset
        self.client_num = int(client_num)
        self.device = get_device(args, device)
        self.trainer = LocalTrainer(model, args)
        #: the model's parameter order, restored on every received dict
        self.order = [n for n, _ in model.module.named_parameters()]
        self.server_opt = ServerOptimizer(args)
        key = rng_util.root_key(int(getattr(args, "random_seed", 0)))
        params = model.init(rng_util.purpose_key(key, "init"))
        params = {k: v.to(self.device) for k, v in params.items()}
        self.state = self.server_opt.init(params)
        self.model_dict: Dict[int, Any] = {}
        self.partial_dict: Dict[int, Any] = {}
        self.sample_num_dict: Dict[int, float] = {}
        self.flag_client_model_uploaded_dict = {
            i: False for i in range(self.client_num)}
        self._test = None
        #: the last server evaluation: {"round", "loss", "acc"} or None
        self.last_eval = None
        use_layout(model)
        FedMLDefender.get_instance().init(args)
        FedMLDifferentialPrivacy.get_instance().init(args)

    def get_global_model_params(self):
        return self.state.global_params

    def set_global_model_params(self, params):
        self.state = self.state.replace(
            global_params=tensor_tree(params, self.device, self.order))

    def add_local_trained_result(self, index: int, model_params, sample_num):
        self.model_dict[index] = model_params
        self.sample_num_dict[index] = float(sample_num)
        self.flag_client_model_uploaded_dict[index] = True

    # -- two-tier silo->server aggregation ----------------------------------
    def add_local_partial_aggregate(self, index: int, partial, sample_num):
        """Hierarchical upload path: silo ``index`` ships the PARTIAL
        aggregate of its whole cohort slice
        (``ServerOptimizer.compute_partial_aggregates``) instead of raw
        per-client models.  Rides the same received-flag round barrier as
        raw uploads."""
        self.partial_dict[index] = partial
        self.sample_num_dict[index] = float(sample_num)
        self.flag_client_model_uploaded_dict[index] = True

    def aggregate_partials(self):
        """Combine the buffered silo partials exactly
        (``federated.combine_partial_aggregates``) and run the unchanged
        server transition."""
        idxs = sorted(self.partial_dict.keys())
        partials = [tensor_tree(self.partial_dict[i], self.device)
                    for i in idxs]
        agg = federated.combine_partial_aggregates(self.server_opt.spec,
                                                   partials)
        self.state = self.server_opt.update_from_aggregates(self.state, agg)
        self.partial_dict.clear()
        return self.state.global_params

    def check_whether_all_receive(self) -> bool:
        if not all(self.flag_client_model_uploaded_dict.values()):
            return False
        self.reset_receive_flags()
        return True

    @property
    def received_count(self) -> int:
        return sum(self.flag_client_model_uploaded_dict.values())

    def reset_receive_flags(self):
        for i in range(self.client_num):
            self.flag_client_model_uploaded_dict[i] = False

    #: user-supplied alg-frame ServerAggregator (hook pipeline); set by the
    #: Server facade when the caller passes server_aggregator=...
    user_aggregator = None

    def aggregate(self):
        if self.partial_dict and not self.model_dict:
            # every buffered upload this round was a silo partial
            return self.aggregate_partials()
        idxs = sorted(self.model_dict.keys())
        raw_list = [(self.sample_num_dict[i],
                     tensor_tree(self.model_dict[i], self.device, self.order))
                    for i in idxs]
        if self.user_aggregator is not None:
            return self._aggregate_via_user_hooks(idxs, raw_list)
        defender = FedMLDefender.get_instance()
        dp = FedMLDifferentialPrivacy.get_instance()
        if defender.is_defense_enabled():
            raw_list = defender.defend_before_aggregation(
                raw_list, self.state.global_params)
        if dp.is_global_dp_enabled() and dp.is_clipping():
            raw_list = dp.global_clip(raw_list)
        if defender.is_defense_on_aggregation():
            new_params = defender.defend_on_aggregation(
                raw_list, base_aggregation_func=lambda lst:
                tree_util.weighted_average([p for _, p in lst],
                                           [n for n, _ in lst]))
            self.state = self.state.replace(
                round_idx=self.state.round_idx + 1, global_params=new_params)
        else:
            stacked = tree_util.tree_stack([p for _, p in raw_list])
            weights = torch.tensor([n for n, _ in raw_list],
                                   dtype=torch.float32, device=self.device)
            self.state = self.server_opt.update(self.state, stacked, weights)
        new_params = self.state.global_params
        if defender.is_defense_after_aggregation():
            new_params = defender.defend_after_aggregation(new_params)
        if dp.is_global_dp_enabled():
            new_params = dp.add_global_noise(new_params)
        self.state = self.state.replace(global_params=new_params)
        self.model_dict.clear()
        return new_params

    def _aggregate_via_user_hooks(self, idxs, raw_list):
        """The server flow when a user ServerAggregator is given:
        ``on_before_aggregation`` → ``aggregate`` →
        ``on_after_aggregation`` → ``assess_contribution``."""
        ua = self.user_aggregator
        ua.set_model_params(self.state.global_params)
        n_before = len(raw_list)
        raw_list, _ = ua.on_before_aggregation(raw_list)
        new_params = ua.aggregate(raw_list)
        new_params = ua.on_after_aggregation(new_params)
        self.state = self.state.replace(
            round_idx=self.state.round_idx + 1,
            global_params=tensor_tree(new_params, self.device, self.order))
        mgr = getattr(ua, "contribution_assessor_mgr", None)
        if mgr is not None and mgr.get_assessor() is not None \
                and self.dataset is not None:
            if len(raw_list) != n_before:
                # a filtering defense changed the list; positional mapping
                # to client ids is gone — crediting would be wrong
                log.warning("skipping contribution assessment: defense "
                            "filtered the cohort (%d -> %d)", n_before,
                            len(raw_list))
            else:
                test = self._test_batches()
                ua.assess_contribution(
                    idxs, raw_list, self.state.global_params,
                    lambda params: float(self.trainer.evaluate(params,
                                                               *test)[1]))
        self.model_dict.clear()
        return self.state.global_params

    def client_sampling(self, round_idx: int, client_num_in_total: int,
                        client_num_per_round: int):
        return rng_util.sample_clients(
            int(getattr(self.args, "random_seed", 0)), round_idx,
            client_num_in_total, client_num_per_round).tolist()

    def _test_batches(self):
        """The dataset's test batches on ``device`` (copied once)."""
        if self._test is None:
            self._test = tuple(torch.as_tensor(a, device=self.device)
                               for a in self.dataset.test_batches())
        return self._test

    def test_on_server_for_all_clients(self, round_idx: int) -> Optional[float]:
        if self.dataset is None:
            return None
        freq = int(getattr(self.args, "frequency_of_the_test", 5))
        rounds = int(getattr(self.args, "comm_round", 0))
        if round_idx % freq != 0 and round_idx != rounds - 1:
            return None
        loss, acc = self.trainer.evaluate(self.state.global_params,
                                          *self._test_batches())
        self.last_eval = {"round": round_idx, "loss": loss, "acc": acc}
        log.info("server eval round %d: loss=%.4f acc=%.4f", round_idx, loss,
                 acc)
        return acc
