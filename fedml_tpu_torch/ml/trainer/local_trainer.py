"""LocalTrainer (port of ``fedml_tpu.ml.trainer.local_trainer``) for the
FedAvg family.

A client's round is a pure function of the global params and its stacked
batches: a loop over its (epochs × steps) batches, each step
``torch.func.grad_and_value`` of the loss through ``functional_call``, a
functional optimizer update (:mod:`..core.state`), and the step mask.  It
has no side effects, so :func:`~fedml_tpu_torch.core.federated.client_map`
can ``torch.func.vmap`` it over a cohort.

A padded step (mask 0) is a TRUE no-op: params and optimizer state are
kept by ``torch.where``, not merely fed a zero gradient, so weight decay,
momentum and Adam's count stay frozen.  The round loss is the mean over the
client's real steps.

The other algorithms of the JAX package (FedProx, SCAFFOLD, FedDyn, Mime,
FedNova, ...) are not ported yet and raise by name.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ...core import federated
from ...core.state import make_client_optimizer
from ...models.base import TorchModel


class ClientOut(NamedTuple):
    params: Any           # stacked {name: (C, ...)} client params
    num_steps: torch.Tensor
    loss: torch.Tensor


def cross_entropy_loss(logits, labels):
    """Mean softmax cross-entropy, computed in f32."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    return -torch.mean(ll)


def accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, dim=-1) == labels)
                      .to(torch.float32))


class LocalTrainer:
    """Builds the pure per-client functions; owns no mutable state."""

    def __init__(self, model: TorchModel, args):
        self.model = model
        self.args = args
        # raises for the unported algorithms
        self.algorithm = federated.check_algorithm(
            str(getattr(args, "federated_optimizer", "FedAvg")))
        if model.task != "classification":
            raise NotImplementedError(f"task {model.task!r} is not ported")
        self.tx = make_client_optimizer(args)

    # -- loss ----------------------------------------------------------------
    def loss_fn(self, params, x, y, dropout_masks=None):
        logits = self.model.apply(params, x, train=True,
                                  dropout_masks=dropout_masks)
        return cross_entropy_loss(logits, y)

    # -- one step (pure) -----------------------------------------------------
    def train_step(self, carry, x, y, mask, dropout_masks=None):
        params, opt_state, nsteps, loss_acc = carry
        grads, loss = torch.func.grad_and_value(self.loss_fn)(
            params, x, y, dropout_masks)
        # mask BEFORE the optimizer so a padded batch never leaks in
        grads = {k: g * mask for k, g in grads.items()}
        updates, new_opt = self.tx.update(grads, opt_state, params)
        new_params = {k: p + updates[k] for k, p in params.items()}
        keep = mask > 0
        new_params = {k: torch.where(keep, v, params[k])
                      for k, v in new_params.items()}
        new_opt = {k: torch.where(keep, v, opt_state[k])
                   for k, v in new_opt.items()}
        return new_params, new_opt, nsteps + mask, loss_acc + loss * mask

    # -- a client's whole round ----------------------------------------------
    def make_local_train(self):
        """Pure ``(global_params, xb, yb, mask, drop) -> (params, num_steps,
        loss)``: ``xb``/``yb`` are ``(steps, batch, ...)``, ``mask`` is
        ``(steps,)`` of 0/1, ``drop`` the per-step dropout keep-masks (a
        tuple of ``(steps, batch, ...)``) or ``None``."""

        def local_train(global_params, xb, yb, mask, drop=None):
            zero = torch.zeros((), dtype=torch.float32, device=mask.device)
            carry = (global_params, self.tx.init(global_params), zero, zero)
            for s in range(xb.shape[0]):
                masks_s = None if drop is None else tuple(d[s] for d in drop)
                carry = self.train_step(carry, xb[s], yb[s], mask[s],
                                        masks_s)
            params, _, nsteps, loss_sum = carry
            return params, nsteps, loss_sum / torch.clamp(nsteps, min=1.0)

        return local_train

    # -- evaluation ----------------------------------------------------------
    def make_eval_step(self):
        def eval_step(params, x, y, m):
            """Summed (loss, hits, count) over the valid examples of one
            batch; ``m`` masks the zero-padded ragged tail."""
            logits = self.model.apply(params, x, train=False)
            logp = F.log_softmax(logits.to(torch.float32), dim=-1)
            ll = torch.gather(logp, -1, y[..., None])[..., 0]
            hit = (torch.argmax(logits, -1) == y).to(torch.float32)
            return -torch.sum(ll * m), torch.sum(hit * m), torch.sum(m)

        return eval_step

    @torch.no_grad()
    def evaluate(self, params, xb, yb, mb):
        """Loss and accuracy over pre-batched test data ``(steps, batch,
        ...)`` (host arrays or tensors), summed batch by batch in f32."""
        dev = next(iter(params.values())).device
        eval_step = self.make_eval_step()
        tot = torch.zeros(3, dtype=torch.float32, device=dev)
        xb, yb, mb = (torch.as_tensor(a, device=dev) for a in (xb, yb, mb))
        for x, y, m in zip(xb, yb, mb):
            tot = tot + torch.stack(eval_step(params, x, y, m))
        loss, acc = (tot[:2] / tot[2]).tolist()
        return loss, acc
