"""FedSeg — federated semantic segmentation (port of
``fedml_tpu.simulation.sp.fedseg``): FedAvg over an encoder-decoder
segmentation net (``models/unet.py``) with per-pixel cross-entropy, and
mIoU evaluation.

Each sampled client runs its local loop eagerly on the engine's device:
SGD with momentum 0.9 from a fresh optimizer state, over its
``client_batches(..., epochs=args.epochs)``; the server takes the
sample-weighted average.  Runs on the card unless ``device`` (or
``args.device``) asks for the CPU."""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from ...core import rng as rng_util
from ...core.state import ClientOptimizer
from ...core.tree import weighted_average
from ...device import get_device
from ...models.unet import mean_iou

log = logging.getLogger(__name__)


def pixel_cross_entropy(logits, labels):
    """Mean cross-entropy over every pixel: logits (B, H, W, C), labels
    (B, H, W) int."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[..., None]))


class FedSegAPI:
    def __init__(self, args, dataset, model, device=None):
        """``model``: a :class:`TorchModel` of ``UNetSmall``
        (``task="segmentation"``); ``dataset``: a FederatedDataset whose
        ``train_y`` is (N, H, W)."""
        self.args = args
        self.dataset = dataset
        self.model = model
        self.device = get_device(args, device)
        self.rounds = int(getattr(args, "comm_round", 3))
        self.clients_per_round = int(getattr(args, "client_num_per_round", 4))
        self.batch_size = int(getattr(args, "batch_size", 8))
        self.seed = int(getattr(args, "random_seed", 0))
        self.tx = ClientOptimizer("sgd", float(getattr(args, "learning_rate",
                                                       0.05)), momentum=0.9)
        root = rng_util.root_key(self.seed, self.device)
        self.params = model.init(rng_util.purpose_key(root, "init"))

    def _loss(self, params, x, y):
        return pixel_cross_entropy(self.model.apply(params, x, train=True), y)

    def local_train(self, params, xb, yb):
        """One client's steps over ``(steps, B, H, W, C)`` images and
        ``(steps, B, H, W)`` masks: ``(params, per-step losses)``."""
        opt = self.tx.init(params)
        losses = []
        for x, y in zip(xb, yb):
            g, loss = torch.func.grad_and_value(self._loss)(params, x, y)
            upd, opt = self.tx.update(g, opt, params)
            params = {k: v + upd[k] for k, v in params.items()}
            losses.append(loss)
        return params, torch.stack(losses)

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device)

    def train(self) -> dict:
        history = []
        epochs = int(getattr(self.args, "epochs", 1))
        for r in range(self.rounds):
            rng = np.random.default_rng(self.seed + r)
            cohort = rng.choice(self.dataset.num_clients,
                                size=min(self.clients_per_round,
                                         self.dataset.num_clients),
                                replace=False)
            locals_, ws, last = [], [], []
            for c in cohort:
                xb, yb = self.dataset.client_batches(
                    int(c), self.batch_size, self.seed, r, epochs=epochs)
                p, ls = self.local_train(self.params, self._tensor(xb),
                                         self._tensor(yb))
                locals_.append(p)
                ws.append(float(len(self.dataset.client_idxs[int(c)])))
                last.append(ls[-1])
            self.params = weighted_average(locals_, ws)
            loss = sum(torch.stack(last).tolist())
            miou = self.evaluate()
            history.append({"round": r, "train_loss": loss / len(cohort),
                            "miou": miou})
            log.info("fedseg round %d: loss=%.4f mIoU=%.4f", r,
                     history[-1]["train_loss"], miou)
        return {"history": history, "params": self.params}

    @torch.no_grad()
    def evaluate(self) -> float:
        """mIoU of each test batch of 32 (the zero-padded rows of the last
        dropped), averaged over the batches."""
        xb, yb, mask = self.dataset.test_batches(32)
        scores = []
        for x, y, m in zip(xb, yb, mask):
            keep = m > 0
            x, y = x[keep], y[keep]
            if len(x) == 0:
                continue
            scores.append(mean_iou(
                self.model.apply(self.params, self._tensor(x)),
                self._tensor(y), self.dataset.num_classes))
        return float(np.mean(torch.stack(scores).tolist())) if scores \
            else 0.0
