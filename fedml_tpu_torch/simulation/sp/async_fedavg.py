"""Asynchronous FedAvg (port of ``fedml_tpu.simulation.sp.async_fedavg``;
reference ``simulation/mpi/async_fedavg/``): the server merges each client
update on ARRIVAL instead of waiting for the cohort, discounting stale
updates.

Each sampled client trains from the global model as of its dispatch and
draws a latency of 0..``async_max_latency`` ticks (host Philox stream,
bitwise the JAX engine's).  At the end of each tick the server mixes the
updates due, in arrival order, into the global model with weight
``α·(1 + τ)^(−a)``, τ the number of merges since the update's dispatch
(FedAsync, Xie et al.).
"""

from __future__ import annotations

import torch

from ...core import hostrng
from ...core import rng as rng_util
from ...ml.trainer.local_trainer import ServerCtx
from .fedavg_api import FedAvgAPI, fedavg_inside


class AsyncFedAvgAPI(FedAvgAPI):
    #: its rounds run FedAvg inside an engine of its own: the quantized
    #: collective layer is not ported to it
    QUANTIZED_ROUNDS = False
    CLIENT_STATE_PLANE = False
    #: its rounds return no per-client lanes: no obs row, ``health``
    #: refused by name
    OBS_ROUNDS = False
    #: ``federated_optimizer`` names that select this engine
    NAMES = ("async_fedavg", "fedasync")

    def __init__(self, args, device, dataset, model, client_mode="vmap"):
        super().__init__(args, device, dataset, model, client_mode,
                         algorithm=fedavg_inside(args, "async", self.NAMES))
        self.mix_alpha = float(getattr(args, "async_alpha", 0.6))
        self.staleness_a = float(getattr(args, "async_staleness_a", 0.5))
        self.max_latency = int(getattr(args, "async_max_latency", 4))
        self._local_train = self.trainer.make_local_train()
        self._version = 0
        # (arrival tick, dispatch version, client, params, samples)
        self._pending = []

    def _staleness_weight(self, staleness: float) -> float:
        # polynomial staleness: s(τ) = (1+τ)^(−a)
        return float((1.0 + staleness) ** (-self.staleness_a))

    def train_one_round(self, round_idx: int):
        """One tick: dispatch the sampled clients with the CURRENT model,
        then merge every pending update whose latency has elapsed."""
        clients = self._client_sampling(round_idx)
        lat_rng = hostrng.gen(self.seed, 0xA51C, round_idx)
        losses = []
        for c in clients:
            xb, yb = self._to_device(*self.dataset.client_batches(
                int(c), self.batch_size, self.seed, round_idx, self.epochs))
            mask = torch.ones((xb.shape[0],), dtype=torch.float32,
                              device=self.device)
            gen = rng_util.client_key(self._root, round_idx, int(c))
            drop = (self.model.dropout_masks(gen, tuple(xb.shape[:2]))
                    if self.model.has_dropout else None)
            g = self.state.global_params
            out = self._local_train(g, xb, yb, mask, drop,
                                    ServerCtx(global_params=g), None)
            latency = int(lat_rng.integers(0, self.max_latency + 1))
            self._pending.append((round_idx + latency, self._version, int(c),
                                  out["params"],
                                  len(self.dataset.client_idxs[int(c)])))
            losses.append(out["loss"])
        # merge the arrivals due this tick, in arrival order
        due = sorted([p for p in self._pending if p[0] <= round_idx],
                     key=lambda p: p[0])
        self._pending = [p for p in self._pending if p[0] > round_idx]
        for _, dispatch_v, _, params, _ in due:
            staleness = self._version - dispatch_v
            alpha = self.mix_alpha * self._staleness_weight(staleness)
            self.state = self.state.replace(
                global_params={k: (1 - alpha) * gv + alpha * params[k]
                               for k, gv in self.state.global_params.items()},
                round_idx=self.state.round_idx + 1)
            self._version += 1
        loss = (torch.mean(torch.stack(losses)) if losses
                else torch.tensor(float("nan")))
        return {"train_loss": loss, "merged": len(due)}
