"""Hierarchical FL (port of ``fedml_tpu.simulation.sp.hierarchical_fl``;
reference ``simulation/sp/hierarchical_fl/trainer.py:10``): group-wise
FedAvg for ``group_comm_round`` inner rounds, then a global merge.

Groups are a static split of the sampled clients (``client % group_num``).
A global round runs ``group_comm_round`` inner rounds in which each group
trains from and merges into its own model, then one weighted merge of the
group models.  Inner round steps are not padded to a power of two, as in
the JAX engine.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import rng as rng_util
from ...core import tree as tree_util
from .fedavg_api import FedAvgAPI, fedavg_inside


class HierarchicalFedAvgAPI(FedAvgAPI):
    #: its rounds run FedAvg inside an engine of its own: the quantized
    #: collective layer is not ported to it
    QUANTIZED_ROUNDS = False
    CLIENT_STATE_PLANE = False
    #: its rounds return no per-client lanes: no obs row, ``health``
    #: refused by name
    OBS_ROUNDS = False
    #: ``federated_optimizer`` names that select this engine
    NAMES = ("hierarchicalfl", "hierarchical_fl")

    def __init__(self, args, device, dataset, model,
                 client_mode: str = "vmap"):
        super().__init__(args, device, dataset, model, client_mode,
                         algorithm=fedavg_inside(args, "hierarchical",
                                                 self.NAMES))
        self.group_num = int(getattr(args, "group_num", 2))
        self.group_comm_round = int(getattr(args, "group_comm_round", 2))

    def _group_of(self, clients: np.ndarray) -> np.ndarray:
        """Static client → group assignment."""
        return np.asarray(clients) % self.group_num

    def train_one_round(self, round_idx: int):
        """One global round: ``group_comm_round`` inner rounds of
        group-local FedAvg, then the weighted merge of the group models."""
        clients = self._client_sampling(round_idx)
        groups = self._group_of(clients)
        group_params = [self.state.global_params] * self.group_num
        group_weights = np.zeros(self.group_num, dtype=np.float32)
        metrics = None
        for inner in range(self.group_comm_round):
            inner_round = round_idx * self.group_comm_round + inner
            for g in range(self.group_num):
                members = clients[groups == g]
                if len(members) == 0:
                    continue
                gen = rng_util.round_key(self._root, inner_round * 131 + g)
                state_g = self.state.replace(global_params=group_params[g])
                if hasattr(self, "_dev_x"):
                    idx, mask, w = self.dataset.cohort_indices(
                        members, self.batch_size, self.seed, inner_round,
                        self.epochs)
                    state_g, metrics, _ = self.round_fn(
                        state_g, *self._to_device(idx, mask, w), gen, None)
                else:
                    x, y, mask, w = self.dataset.cohort_batches(
                        members, self.batch_size, self.seed, inner_round,
                        self.epochs)
                    state_g, metrics, _ = self.round_fn(
                        state_g, *self._to_device(x, y, mask, w), gen, None)
                group_params[g] = state_g.global_params
                group_weights[g] = float(np.sum(w))
        live = group_weights > 0
        merged = tree_util.stacked_weighted_average(
            tree_util.tree_stack([p for p, l in zip(group_params, live)
                                  if l]),
            torch.as_tensor(group_weights[live], device=self.device))
        self.state = self.state.replace(global_params=merged,
                                        round_idx=self.state.round_idx + 1)
        return metrics if metrics is not None else {
            "train_loss": float("nan")}
