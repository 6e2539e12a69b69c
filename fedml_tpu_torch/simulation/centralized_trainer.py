"""Centralized (non-federated) baseline trainer (port of
``fedml_tpu.simulation.centralized_trainer``): trains the model on the
pooled training set, the upper-bound curve that federated runs on the same
split are compared against.

Each epoch is one pass over a fresh permutation of the pooled rows (the
ragged tail dropped) with the client optimizer of ``args``
(``client_optimizer`` sgd or adam, ``learning_rate``, ...), eagerly on the
trainer's device; dropout keep-masks for the epoch come from its own
generator.  Every ``frequency_of_train_acc_report`` epochs, and at the
last, the test loss and accuracy join the epoch's record in
``self.history``.  Runs on the card unless ``device`` (or ``args.device``)
asks for the CPU."""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..core import rng as rng_util
from ..core.state import make_client_optimizer
from ..device import get_device
from ..ml.trainer.local_trainer import (LocalTrainer, accuracy,
                                        cross_entropy_loss)

log = logging.getLogger(__name__)


class CentralizedTrainer:
    """Construct with ``(dataset, model, device, args)`` and call
    ``train()``; per-epoch metrics land in ``self.history``."""

    def __init__(self, dataset, model, device, args):
        self.dataset = dataset
        self.model = model
        self.device = get_device(args, device)
        self.args = args
        self.batch_size = int(getattr(args, "batch_size", 32))
        self.epochs = int(getattr(args, "epochs", 5))
        self.eval_freq = int(getattr(args, "frequency_of_train_acc_report",
                                     getattr(args, "frequency_of_the_test", 1)))
        self.seed = int(getattr(args, "random_seed", 0))
        self.tx = make_client_optimizer(args)
        self._root = rng_util.root_key(self.seed, self.device)
        self.params = model.init(self._root)
        self.opt_state = self.tx.init(self.params)
        self._evaluator = LocalTrainer(model, args, algorithm="fedavg")
        self.history: list = []

    def _loss(self, params, x, y, masks):
        logits = self.model.apply(params, x, train=True, dropout_masks=masks)
        return cross_entropy_loss(logits, y), accuracy(logits, y)

    def _epoch_batches(self, epoch_idx: int):
        rng = np.random.default_rng(self.seed * 100003 + epoch_idx)
        order = rng.permutation(len(self.dataset.train_x))
        steps = len(order) // self.batch_size
        order = order[: steps * self.batch_size].reshape(steps,
                                                         self.batch_size)
        return (self.dataset.train_x[order], self.dataset.train_y[order])

    def run_epoch(self, epoch: int):
        """One pass over the epoch's batches: the mean step loss and
        accuracy."""
        xb, yb = (torch.as_tensor(a, device=self.device)
                  for a in self._epoch_batches(epoch))
        masks = self.model.dropout_masks(rng_util.round_key(self._root, epoch),
                                         tuple(xb.shape[:2]))
        losses, accs = [], []
        for s in range(xb.shape[0]):
            grads, (loss, acc) = torch.func.grad_and_value(
                self._loss, has_aux=True)(self.params, xb[s], yb[s],
                                          tuple(m[s] for m in masks))
            upd, self.opt_state = self.tx.update(grads, self.opt_state,
                                                 self.params)
            self.params = {k: v + upd[k] for k, v in self.params.items()}
            losses.append(loss)
            accs.append(acc)
        return torch.mean(torch.stack(losses)), torch.mean(torch.stack(accs))

    def train(self):
        for epoch in range(self.epochs):
            loss, acc = self.run_epoch(epoch)
            rec = {"epoch": epoch, "train_loss": float(loss),
                   "train_acc": float(acc)}
            if epoch % max(self.eval_freq, 1) == 0 or epoch == self.epochs - 1:
                test_loss, test_acc = self.evaluate()
                rec.update(test_loss=test_loss, test_acc=test_acc)
            self.history.append(rec)
            log.info("centralized epoch %d: %s", epoch, rec)
        return self.history

    def evaluate(self):
        """Test loss and accuracy over the padded test batches."""
        xb, yb, mask = self.dataset.test_batches(max(self.batch_size, 64))
        return self._evaluator.evaluate(self.params, xb, yb, mask)
