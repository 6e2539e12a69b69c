"""Decentralized FL — DSGD / push-sum (port of
``fedml_tpu.simulation.sp.decentralized``; reference ``simulation/sp/
decentralized/client_dsgd.py``, topology managers in
``core/distributed/topology/``).

No server: every client keeps its own model.  A round is local SGD on every
client from its own params, then neighbour gossip ``x ← W x`` with the
topology's mixing matrix W: one f32 ``einsum`` per leaf of the stacked
client params.  Push-sum (the asymmetric topology) tracks the scalar weight
ω alongside and de-biases the consensus by it.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import federated
from ...core import rng as rng_util
from ...core import tree as tree_util
from ...core.distributed.topology.topology_manager import (
    AsymmetricTopologyManager, SymmetricTopologyManager)
from ...device import get_device
from ...ml.trainer.local_trainer import LocalTrainer, ServerCtx
from ..round_engine import next_pow2
from .fedavg_api import fedavg_inside, refuse_round_options


class DecentralizedFedAPI:
    """All-client DSGD simulator; :meth:`evaluate` scores the consensus
    estimate (the client average).  Runs on the card unless ``device`` (or
    ``args.device``) asks for the CPU."""

    #: ``federated_optimizer`` names that select this engine
    NAMES = ("decentralized_fl", "dsgd", "push_sum")

    def __init__(self, args, device, dataset, model):
        algorithm = fedavg_inside(args, "decentralized", self.NAMES)
        refuse_round_options(args, type(self).__name__)
        self.args = args
        self.device = get_device(args, device)
        self.dataset = dataset
        self.model = model
        self.seed = int(getattr(args, "random_seed", 0))
        self.batch_size = int(getattr(args, "batch_size", 10))
        self.epochs = int(getattr(args, "epochs", 1))
        self.comm_rounds = int(getattr(args, "comm_round", 10))
        self.n = int(getattr(args, "client_num_in_total", 8))
        topo = str(getattr(args, "topology", "symmetric")).lower()
        nbrs = int(getattr(args, "topology_neighbors", 2))
        mgr = (SymmetricTopologyManager(self.n, nbrs) if topo == "symmetric"
               else AsymmetricTopologyManager(self.n, nbrs))
        self.W = torch.as_tensor(mgr.mixing_matrix(), device=self.device)
        self.push_sum = topo == "asymmetric"

        self.trainer = LocalTrainer(model, args, algorithm)
        # the initial weights are drawn on the CPU (as FedAvgAPI's); every
        # client starts from the same init
        params0 = model.init(rng_util.purpose_key(rng_util.root_key(self.seed),
                                                  "init"))
        self.params = {k: torch.stack([v] * self.n).to(self.device)
                       for k, v in params0.items()}
        self.omega = torch.ones(self.n, device=self.device)
        self._root = rng_util.root_key(self.seed, self.device)
        local_train = self.trainer.make_local_train()

        def per_client(p, xb, yb, mb, db):
            return local_train(p, xb, yb, mb, db, ServerCtx(global_params=p),
                               None)

        self._clients = federated.client_map(per_client, "vmap")

    def train_one_round(self, round_idx: int):
        clients = np.arange(self.n)
        x, y, mask, _ = self.dataset.cohort_batches(
            clients, self.batch_size, self.seed, round_idx, self.epochs)
        pad = next_pow2(x.shape[1]) - x.shape[1]
        if pad:
            x = np.pad(x, [(0, 0), (0, pad)] + [(0, 0)] * (x.ndim - 2))
            y = np.pad(y, [(0, 0), (0, pad)] + [(0, 0)] * (y.ndim - 2))
            mask = np.pad(mask, [(0, 0), (0, pad)])
        x, y, mask = (torch.as_tensor(a, device=self.device)
                      for a in (x, y, mask))
        gen = rng_util.round_key(self._root, round_idx)
        drop = (self.model.dropout_masks(gen, tuple(x.shape[:3]))
                if self.model.has_dropout else None)
        outs = self._clients(self.params, x, y, mask, drop)
        # gossip: x ← W x, one einsum per leaf
        self.params = tree_util.tree_map(
            lambda l: torch.einsum("ij,j...->i...", self.W,
                                   l.to(torch.float32)).to(l.dtype),
            outs["params"])
        self.omega = self.W @ self.omega
        return {"train_loss": torch.mean(outs["loss"])}

    def consensus_params(self):
        """The client average, de-biased by ω under push-sum."""
        ones = torch.ones(self.n, device=self.device)
        if self.push_sum:
            ratio = tree_util.tree_map(
                lambda l: l / self.omega.reshape((-1,) + (1,) * (l.dim() - 1)),
                self.params)
            return tree_util.stacked_weighted_average(ratio, ones)
        return tree_util.stacked_weighted_average(self.params, ones)

    def evaluate(self):
        return self.trainer.evaluate(self.consensus_params(),
                                     *self.dataset.test_batches())

    def train(self):
        for r in range(self.comm_rounds):
            self.train_one_round(r)
        return self.consensus_params()
