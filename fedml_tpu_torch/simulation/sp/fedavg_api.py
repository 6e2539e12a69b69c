"""Single-process federated simulation (port of
``fedml_tpu.simulation.sp.fedavg_api.FedAvgAPI``) for every synchronous
algorithm of the zoo (``core/federated.py``'s registry).

Per round: sample the cohort (host Philox stream, bitwise the JAX
package's), stage its ``(C, S, B)`` index tensor, step mask and weights
with the steps padded to a power of two, gather the cohort's rows of the
per-client state table (SCAFFOLD/FedDyn), run the round function of
:mod:`..round_engine` on the device-resident dataset, scatter the updated
rows back, and keep the round's metrics on the device until a log round
reads them.  Evaluation runs every ``frequency_of_the_test`` rounds and at
the last.

The JAX engine's tracing, health, population, bucketing, fused-block,
client-store, data-paging, quantized-collective, checkpoint and
registered-population options are not ported: each raises
``NotImplementedError`` naming itself when set.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ...core import rng as rng_util
from ...core import tree as tree_util
from ...data.federated_dataset import FederatedDataset
from ...device import get_device
from ...ml.aggregator.agg_operator import ServerOptimizer
from ...ml.trainer.local_trainer import LocalTrainer
from ...models.base import TorchModel
from ..round_engine import make_gather_round_fn, make_round_fn, next_pow2

log = logging.getLogger(__name__)


def _unported_options(args):
    """Names of the set options of the JAX engine the port does not run."""
    g = lambda k, d=None: getattr(args, k, d)
    checks = (
        ("trace", bool(g("trace", False))),
        ("health", bool(g("health", False))),
        ("metrics_port", g("metrics_port") is not None),
        ("population", bool(g("population", 0)) or bool(
            g("population_axes"))),
        ("cohort_bucketing", bool(g("cohort_bucketing", False))),
        ("round_block > 1", int(g("round_block", 1) or 1) > 1),
        ("client_store", bool(g("client_store", False))),
        ("data_paging", bool(g("data_paging", False))),
        ("collective_precision != 'fp32'",
         str(g("collective_precision", "fp32") or "fp32").lower() != "fp32"),
        ("checkpoint_dir", bool(g("checkpoint_dir"))),
        ("registered_clients", bool(int(g("registered_clients", 0) or 0))),
    )
    return [name for name, on in checks if on]


def fedavg_inside(args, engine: str, names) -> str:
    """The algorithm an engine that runs FedAvg rounds inside (the
    hierarchical and async engines, decentralized SGD) runs: "fedavg",
    when ``federated_optimizer`` names the engine itself or the FedAvg
    family.  Any other algorithm raises, so none runs as FedAvg unseen."""
    alg = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
    if alg not in tuple(names) + ("fedavg", "fedavg_seq"):
        raise NotImplementedError(
            f"the {engine} engine runs FedAvg rounds; federated_optimizer "
            f"{alg!r} is not ported to it")
    return "fedavg"


class FedAvgAPI:
    """Runs one algorithm of the zoo on one device.

    ``client_mode``: "scan" (clients one after another) or "vmap" (clients
    batched by ``torch.func.vmap``).  ``device`` goes through
    :func:`~fedml_tpu_torch.device.get_device` (None: the card unless
    ``args.device`` is "cpu"), which also sets the card's f32 policy.
    ``algorithm`` (default: ``args.federated_optimizer``) names the
    algorithm; the hierarchical and async engines pass "fedavg".

    ``client_table`` is the per-client state of SCAFFOLD/FedDyn: one row
    per dataset client on the device, zero until the client is sampled
    (``None`` for the other algorithms)."""

    def __init__(self, args, device, dataset: FederatedDataset,
                 model: TorchModel, client_mode: str = "vmap",
                 algorithm=None):
        unported = _unported_options(args)
        if unported:
            raise NotImplementedError(
                f"{', '.join(unported)}: not implemented by the port's sp "
                "engine yet (unset to run)")
        self.args = args
        self.device = get_device(args, device)
        self.dataset = dataset
        self.model = model
        self.seed = int(getattr(args, "random_seed", 0))
        self.batch_size = int(getattr(args, "batch_size", 10))
        self.epochs = int(getattr(args, "epochs", 1))
        self.comm_rounds = int(getattr(args, "comm_round", 10))
        self.clients_per_round = int(getattr(args, "client_num_per_round", 10))
        self.eval_freq = int(getattr(args, "frequency_of_the_test", 5))

        self.trainer = LocalTrainer(model, args, algorithm)
        self.server_opt = ServerOptimizer(args, algorithm)
        # the initial weights are drawn on the CPU, so a seed gives the same
        # model on every device; the rounds draw on the device
        params = model.init(rng_util.purpose_key(rng_util.root_key(self.seed),
                                                 "init"))
        self.state = self.server_opt.init(
            {k: v.to(self.device) for k, v in params.items()})
        self._root = rng_util.root_key(self.seed, self.device)
        self._test = None
        self.round_fn = self._build_round_fn(client_mode)
        self.client_table = None
        if self.server_opt.spec.client_state:
            self.client_table = tree_util.client_table_init(
                self.state.global_params, self.dataset.num_clients)
        self.metrics_history = []

    def _build_round_fn(self, client_mode: str):
        if bool(getattr(self.args, "device_data", True)):
            # the training set lives on the device once; rounds ship only
            # index tensors
            self._dev_x = torch.as_tensor(self.dataset.train_x,
                                          device=self.device)
            self._dev_y = torch.as_tensor(self.dataset.train_y,
                                          device=self.device)
            return make_gather_round_fn(self.trainer, self.server_opt,
                                        self._dev_x, self._dev_y,
                                        mode=client_mode)
        return make_round_fn(self.trainer, self.server_opt, mode=client_mode)

    # -- round pieces --------------------------------------------------------
    def _client_sampling(self, round_idx: int) -> np.ndarray:
        return rng_util.sample_clients(self.seed, round_idx,
                                       self.dataset.num_clients,
                                       self.clients_per_round)

    def _stage_round_arrays(self, round_idx: int):
        """The round's index tensor, step mask and client weights, with the
        steps padded to a power of two (a bounded set of shapes)."""
        clients = self._client_sampling(round_idx)
        idx, mask, w = self.dataset.cohort_indices(
            clients, self.batch_size, self.seed, round_idx, self.epochs)
        steps = next_pow2(idx.shape[1])
        if steps != idx.shape[1]:
            pad = steps - idx.shape[1]
            idx = np.pad(idx, [(0, 0), (0, pad), (0, 0)])
            mask = np.pad(mask, [(0, 0), (0, pad)])
        return clients, idx, mask, w, steps

    def _to_device(self, *arrays):
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def _gather_c(self, cohort):
        """The cohort's rows of the per-client state table, stacked, or
        ``None`` for an algorithm without per-client state."""
        if self.client_table is None:
            return None
        return tree_util.cohort_gather(self.client_table, cohort)

    def _scatter_c(self, cohort, new_rows):
        if self.client_table is None or new_rows is None:
            return
        self.client_table = tree_util.cohort_scatter(self.client_table,
                                                     cohort, new_rows)

    def train_one_round(self, round_idx: int):
        gen = rng_util.round_key(self._root, round_idx)
        if hasattr(self, "_dev_x"):
            clients, idx, mask, w, steps = self._stage_round_arrays(round_idx)
            idx, mask, w = self._to_device(idx, mask, w)
            c_stacked = self._gather_c(clients)
            self.state, metrics, new_c = self.round_fn(
                self.state, idx, mask, w, gen, c_stacked)
        else:
            clients = self._client_sampling(round_idx)
            x, y, mask, w = self.dataset.cohort_batches(
                clients, self.batch_size, self.seed, round_idx, self.epochs)
            steps = next_pow2(x.shape[1])
            if steps != x.shape[1]:
                pad = [(0, 0), (0, steps - x.shape[1])]
                x = np.pad(x, pad + [(0, 0)] * (x.ndim - 2))
                y = np.pad(y, pad + [(0, 0)] * (y.ndim - 2))
                mask = np.pad(mask, pad)
            x, y, mask, w = self._to_device(x, y, mask, w)
            c_stacked = self._gather_c(clients)
            self.state, metrics, new_c = self.round_fn(
                self.state, x, y, mask, w, gen, c_stacked)
        self._scatter_c(clients, new_c)
        metrics = dict(metrics)
        metrics["allocated_steps"] = len(clients) * steps
        return metrics

    def evaluate(self):
        if self._test is None:
            self._test = self._to_device(*self.dataset.test_batches())
        return self.trainer.evaluate(self.state.global_params, *self._test)

    # -- main loop -----------------------------------------------------------
    def _is_log_round(self, round_idx: int) -> bool:
        return (round_idx % self.eval_freq == 0
                or round_idx == self.comm_rounds - 1)

    def _flush_round_records(self, pending):
        """Turn deferred per-round metrics into host records.  The
        ``float()`` here is the one device→host sync for every round since
        the last flush."""
        while pending:
            round_idx, metrics, dt = pending.pop(0)
            train_loss = float(metrics["train_loss"])
            record = {"round": round_idx, "train_loss": train_loss,
                      "round_time": dt,
                      "dataset_provenance": getattr(self.dataset,
                                                    "provenance", "unknown")}
            if self._is_log_round(round_idx):
                test_loss, test_acc = self.evaluate()
                record.update(test_loss=test_loss, test_acc=test_acc)
                log.info("round %d: train_loss=%.4f test_acc=%.4f (%.2fs)",
                         round_idx, train_loss, test_acc, dt)
            self.metrics_history.append(record)

    def train(self):
        t_start = time.time()
        pending = []
        for round_idx in range(self.comm_rounds):
            t0 = time.time()
            metrics = self.train_one_round(round_idx)
            pending.append((round_idx, metrics, time.time() - t0))
            if self._is_log_round(round_idx):
                self._flush_round_records(pending)
        self._flush_round_records(pending)
        total = time.time() - t_start
        log.info("finished %d rounds in %.1fs (%.3fs/round)",
                 self.comm_rounds, total, total / max(self.comm_rounds, 1))
        return self.state.global_params
