"""FedNAS — federated differentiable architecture search (port of
``fedml_tpu.simulation.sp.fednas``) over the DARTS supernet
(``models/darts.py``).

Each round, every sampled client runs first-order DARTS on its private
split: a weight step on a train batch, then an architecture (alpha) step
on a validation batch; the server averages weights and alphas alike.  The
local loop runs eagerly on the engine's device.

The two optimizers reproduce the JAX engine's ``optax.multi_transform``
exactly, quirk included: SGD (momentum 0.9) owns the weights and Adam the
``alphas_*`` entries, and BOTH step on every half-step, each on its own
part of a gradient whose other part is zero.  So during the weight step
Adam sees a zero gradient (its moments decay, its count rises and the
alphas still move by its momentum), and during the alpha step SGD keeps
moving the weights by 0.9 × its trace.  Runs on the card unless
``device`` (or ``args.device``) asks for the CPU."""

from __future__ import annotations

import logging

import numpy as np
import torch

from ...core import rng as rng_util
from ...core.state import ClientOptimizer
from ...core.tree import tree_zeros_like, weighted_average
from ...device import get_device
from ...ml.trainer.local_trainer import cross_entropy_loss
from ...models.darts import derive_genotype

log = logging.getLogger(__name__)


def _is_alpha(name: str) -> bool:
    return name.startswith("alphas_")


class FedNASAPI:
    def __init__(self, args, dataset, model, device=None):
        """``model``: a :class:`TorchModel` of ``DARTSNetwork``;
        ``dataset``: a FederatedDataset of images."""
        self.args = args
        self.dataset = dataset
        self.model = model
        self.device = get_device(args, device)
        self.rounds = int(getattr(args, "comm_round", 5))
        self.clients_per_round = int(getattr(args, "client_num_per_round", 4))
        self.batch_size = int(getattr(args, "batch_size", 16))
        self.seed = int(getattr(args, "random_seed", 0))
        self.w_tx = ClientOptimizer(
            "sgd", float(getattr(args, "learning_rate", 0.05)), momentum=0.9)
        self.a_tx = ClientOptimizer(
            "adam", float(getattr(args, "arch_learning_rate", 3e-3)))
        root = rng_util.root_key(self.seed, self.device)
        self.params = model.init(rng_util.purpose_key(root, "init"))

    def _loss(self, w, a, x, y):
        return cross_entropy_loss(self.model.apply({**w, **a}, x, train=True),
                                  y)

    def local_search(self, params, train_b, val_b):
        """One client's paired steps over ``((xt, yt), (xv, yv))``, each
        ``(steps, B, ...)``: ``(params, (weight-step losses, alpha-step
        losses))``."""
        w = {k: v for k, v in params.items() if not _is_alpha(k)}
        a = {k: v for k, v in params.items() if _is_alpha(k)}
        ow, oa = self.w_tx.init(w), self.a_tx.init(a)
        zw, za = tree_zeros_like(w), tree_zeros_like(a)

        def step(w, a, ow, oa, gw, ga):
            uw, ow = self.w_tx.update(gw, ow, w)
            ua, oa = self.a_tx.update(ga, oa, a)
            return ({k: v + uw[k] for k, v in w.items()},
                    {k: v + ua[k] for k, v in a.items()}, ow, oa)

        (xt, yt), (xv, yv) = train_b, val_b
        lws, las = [], []
        for s in range(xt.shape[0]):
            gw, lw = torch.func.grad_and_value(self._loss, argnums=0)(
                w, a, xt[s], yt[s])
            w, a, ow, oa = step(w, a, ow, oa, gw, za)
            ga, la = torch.func.grad_and_value(self._loss, argnums=1)(
                w, a, xv[s], yv[s])
            w, a, ow, oa = step(w, a, ow, oa, zw, ga)
            lws.append(lw)
            las.append(la)
        merged = {**w, **a}
        return ({k: merged[k] for k in params},
                (torch.stack(lws), torch.stack(las)))

    def _paired_batches(self, c: int, round_idx: int):
        """The client's data split in half, train and validation, each
        ``(steps, B, ...)`` on the device."""
        idx = np.asarray(self.dataset.client_idxs[c])
        rng = np.random.default_rng(self.seed * 7919 + round_idx * 31 + c)
        perm = rng.permutation(len(idx))
        half = len(idx) // 2
        bs = min(self.batch_size, max(1, half))
        steps = max(1, half // bs)
        x, y = self.dataset.train_x, self.dataset.train_y

        def take(sel):
            t = idx[sel[:steps * bs]]
            return (torch.as_tensor(x[t].reshape((steps, bs) + x.shape[1:]),
                                    device=self.device),
                    torch.as_tensor(y[t].reshape((steps, bs)),
                                    device=self.device))

        return take(perm[:half]), take(perm[half:])

    def train(self) -> dict:
        history = []
        for r in range(self.rounds):
            rng = np.random.default_rng(self.seed + r)
            cohort = rng.choice(self.dataset.num_clients,
                                size=min(self.clients_per_round,
                                         self.dataset.num_clients),
                                replace=False)
            locals_, ws, last = [], [], []
            for c in cohort:
                train_b, val_b = self._paired_batches(int(c), r)
                p, (l_w, l_a) = self.local_search(self.params, train_b, val_b)
                locals_.append(p)
                ws.append(float(len(self.dataset.client_idxs[int(c)])))
                last.append(torch.stack([l_w[-1], l_a[-1]]))
            self.params = weighted_average(locals_, ws)
            lw, la = (sum(col) for col in zip(*torch.stack(last).tolist()))
            history.append({"round": r, "train_loss": lw / len(cohort),
                            "val_loss": la / len(cohort)})
            log.info("fednas round %d: w_loss=%.4f alpha_loss=%.4f", r,
                     history[-1]["train_loss"], history[-1]["val_loss"])
        return {"history": history, "params": self.params,
                "genotype": derive_genotype(self.params)}
