"""Decentralized (serverless) cross-silo federation (port of
``fedml_tpu.cross_silo.decentralized_manager``): gossip averaging over a
peer topology with no coordinator.

Every silo is a peer: per round it trains its client locally, sends its
model to its out-neighbors (``core/distributed/topology``), waits for its
in-neighbors, and applies the mixing-matrix weighted average (DSGD /
gossip averaging).  Rounds are tagged, so a slow peer's stale gossip
cannot corrupt the next round.  A peer's model lives on ``device`` (the
card unless the CPU is asked for); a model that arrives as host arrays
goes back there in the model's parameter order.  With dropout, a peer's
keep masks come from ``core/rng.client_key(seed, round, rank)``.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict

import torch

from ..core import rng as rng_util
from ..core import tree as tree_util
from ..core.distributed.communication.message import Message
from ..core.distributed.fedml_comm_manager import FedMLCommManager
from ..core.distributed.topology.topology_manager import (
    SymmetricTopologyManager)
from ..core.wire import tensor_tree
from ..ml.trainer.local_trainer import LocalTrainer, ServerCtx

log = logging.getLogger(__name__)

MSG_TYPE_P2P_MODEL = 601
ARG_MODEL = "p2p_model_params"
ARG_ROUND = "p2p_round_idx"


class DecentralizedWorkerManager(FedMLCommManager):
    """One peer.  ``rank`` ∈ [0, size): every rank is a worker (no rank-0
    server); topology indices are comm ranks."""

    def __init__(self, args, dataset, model, comm=None, rank=0, size=0,
                 backend="local", topology=None, device=None):
        from ..device import get_device

        super().__init__(args, comm, rank, size, backend)
        self.topology = topology or SymmetricTopologyManager(
            size, int(getattr(args, "topology_neighbor_num", 2)))
        if getattr(self.topology, "topology", None) is None:
            self.topology.generate_topology()
        self.device = get_device(args, device)
        self.dataset = dataset
        self.model = model
        self.trainer = LocalTrainer(model, args)
        self.rounds = int(getattr(args, "comm_round", 5))
        self.seed = int(getattr(args, "random_seed", 0))
        self.batch_size = int(getattr(args, "batch_size", 32))
        self.epochs = int(getattr(args, "epochs", 1))
        key = rng_util.root_key(self.seed)
        self.params = {k: v.to(self.device) for k, v in model.init(
            rng_util.purpose_key(key, "init")).items()}
        self.order = list(self.params)
        self.round_idx = 0
        self._inbox: Dict[int, Dict[int, Any]] = {}
        self._lock = threading.Lock()
        self._local_train = None

    # -- FSM ----------------------------------------------------------------
    def register_message_receive_handlers(self):
        self.register_message_receive_handler(
            Message.MSG_TYPE_CONNECTION_IS_READY, self._on_ready)
        self.register_message_receive_handler(
            MSG_TYPE_P2P_MODEL, self._on_peer_model)

    def _on_ready(self, _msg):
        self._step_round()

    def _train_local(self):
        clients = [self.rank % self.dataset.num_clients]
        xb, yb, mask, _w = self.dataset.cohort_batches(
            clients, self.batch_size, self.seed, self.round_idx, self.epochs)
        xb, yb, mask = (torch.as_tensor(a[0], device=self.device)
                        for a in (xb, yb, mask))
        drop = None
        if self.model.has_dropout:
            gen = rng_util.client_key(rng_util.root_key(self.seed),
                                      self.round_idx, self.rank)
            drop = tuple(d.to(self.device) for d in self.model.dropout_masks(
                gen, (xb.shape[0], self.batch_size)))
        if self._local_train is None:
            self._local_train = self.trainer.make_local_train()
        out = self._local_train(self.params, xb, yb, mask, drop,
                                ServerCtx(global_params=self.params), None)
        self.params = out["params"]

    def _step_round(self):
        """Train, gossip to out-neighbors, then wait for in-neighbors."""
        self._train_local()
        for peer in self.topology.get_out_neighbor_idx_list(self.rank):
            if peer == self.rank:
                continue
            msg = Message(MSG_TYPE_P2P_MODEL, self.rank, int(peer))
            msg.add_params(ARG_MODEL, self.params)
            msg.add_params(ARG_ROUND, self.round_idx)
            self.send_message(msg)
        self._maybe_mix()

    def _on_peer_model(self, msg):
        sender = msg.get_sender_id()
        rnd = int(msg.get(ARG_ROUND))
        params = tensor_tree(msg.get(ARG_MODEL), self.device, self.order)
        with self._lock:
            self._inbox.setdefault(rnd, {})[sender] = params
        self._maybe_mix()

    def _maybe_mix(self):
        with self._lock:
            expected = [int(p) for p in
                        self.topology.get_in_neighbor_idx_list(self.rank)
                        if int(p) != self.rank]
            box = self._inbox.get(self.round_idx, {})
            if not all(p in box for p in expected):
                return
            weights = self.topology.get_in_neighbor_weights(self.rank)
            mixed = tree_util.tree_scale(self.params,
                                         float(weights[self.rank]))
            for p in expected:
                mixed = tree_util.tree_add(
                    mixed, tree_util.tree_scale(box[p], float(weights[p])))
            self.params = mixed
            self._inbox.pop(self.round_idx, None)
            self.round_idx += 1
            done = self.round_idx >= self.rounds
        if done:
            self.finish()
        else:
            self._step_round()


__all__ = ["DecentralizedWorkerManager", "MSG_TYPE_P2P_MODEL"]
