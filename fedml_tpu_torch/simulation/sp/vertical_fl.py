"""Classical vertical FL (port of ``fedml_tpu.simulation.sp.vertical_fl``):
parties hold DIFFERENT feature columns of the SAME samples; the guest
holds the labels.

Each party computes its partial logit h_p = X_p w_p; the guest sums the
partials, computes ∂L/∂logit of the softmax cross-entropy and sends it
back; each party updates from its own features (plain SGD).  Only partial
logits and logit gradients cross the boundary.  Batches follow the host
stream ``hostrng.gen(seed, 0x7F1, round)``, bitwise the JAX engine's.
Runs on the card unless ``device`` (or ``args.device``) asks for the
CPU."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...core import hostrng, rng as rng_util
from ...core.state import ClientOptimizer
from ...device import get_device


class VerticalPartyModel:
    """One party's linear tower over its feature slice; ``key`` is the
    ``torch.Generator`` of its N(0, 0.01²) initial weights."""

    def __init__(self, n_features: int, out_dim: int, lr: float,
                 key: torch.Generator):
        self.w = 0.01 * torch.randn((n_features, out_dim), generator=key,
                                    device=key.device)
        self.tx = ClientOptimizer("sgd", lr)
        self.opt = self.tx.init({"w": self.w})

    def forward(self, x):
        return x @ self.w

    def backward(self, x, glogit):
        gw = x.T @ glogit / x.shape[0]
        upd, self.opt = self.tx.update({"w": gw}, self.opt, {"w": self.w})
        self.w = self.w + upd["w"]


class VerticalFLAPI:
    """Two-or-more-party VFL driver over a column-partitioned dataset."""

    def __init__(self, args, features: Sequence[np.ndarray], labels: np.ndarray,
                 test_features: Sequence[np.ndarray], test_labels: np.ndarray,
                 num_classes: int, device=None):
        self.args = args
        self.device = get_device(args, device)
        n, n_test = len(labels), len(test_labels)

        def on_device(arrays, rows):
            return [torch.as_tensor(
                np.asarray(f, np.float32).reshape(rows, -1),
                device=self.device) for f in arrays]

        self.features = on_device(features, n)
        self.labels = torch.as_tensor(np.asarray(labels), device=self.device)
        self.test_features = on_device(test_features, n_test)
        self.test_labels = torch.as_tensor(np.asarray(test_labels),
                                           device=self.device)
        self.batch_size = int(getattr(args, "batch_size", 64))
        self.rounds = int(getattr(args, "comm_round", 20))
        self.seed = int(getattr(args, "random_seed", 0))
        lr = float(getattr(args, "learning_rate", 0.1))
        root = rng_util.root_key(self.seed, self.device)
        self.parties: List[VerticalPartyModel] = [
            VerticalPartyModel(f.shape[1], num_classes, lr,
                               rng_util.child_key(root, i))
            for i, f in enumerate(self.features)]

    @staticmethod
    def guest_grad(logits, y):
        """The guest's loss and ∂L/∂logit (softmax − one-hot)."""
        onehot = F.one_hot(y, logits.shape[-1]).to(logits.dtype)
        loss = -torch.mean(torch.sum(onehot * F.log_softmax(logits, -1), -1))
        return loss, torch.softmax(logits, -1) - onehot

    def train(self):
        n = len(self.labels)
        losses = []
        for r in range(self.rounds):
            order = hostrng.gen(self.seed, 0x7F1, r).permutation(n)
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                idx = torch.as_tensor(order[i: i + self.batch_size],
                                      device=self.device)
                xs = [f[idx] for f in self.features]
                logits = sum(p.forward(x) for p, x in zip(self.parties, xs))
                loss, glogit = self.guest_grad(logits, self.labels[idx])
                for p, x in zip(self.parties, xs):
                    p.backward(x, glogit)
                losses.append(loss)
        return torch.stack(losses).tolist() if losses else []

    def evaluate(self) -> float:
        logits = sum(p.forward(f)
                     for p, f in zip(self.parties, self.test_features))
        pred = torch.argmax(logits, -1)
        return float(torch.mean((pred == self.test_labels).to(torch.float32)))
