"""LocalTrainer (port of ``fedml_tpu.ml.trainer.local_trainer``).

A client's round is a pure function of the global params and its stacked
batches: a loop over its (epochs × steps) batches, each step
``torch.func.grad_and_value`` of the loss through ``functional_call``, a
functional optimizer update (:mod:`..core.state`), and the step mask.  It
has no side effects, so :func:`~fedml_tpu_torch.core.federated.client_map`
can ``torch.func.vmap`` it over a cohort.

The algorithms of the zoo hook in as loss and gradient transforms selected
by ``federated_optimizer``:

- FedProx:  loss += (mu/2)·‖w − w_global‖²
- SCAFFOLD: grad += c_server − c_client; c_i⁺ and Δc returned
- FedDyn:   loss += (alpha/2)·‖w − w_global‖² − ⟨∇̂_i, w⟩; ∇̂_i⁺ returned
- Mime:     the step takes (1 − β)·g + β·m with the server momentum m
- FedNova, Mime, FedSGD: the mean gradient over real steps returned;
  FedNova also its real step count τ.

A population sweeps some of the hooks' constants (``prox_mu``,
``feddyn_alpha``, the client lr) through ``ServerCtx.hparams``
(:class:`~fedml_tpu_torch.core.federated.HParams`); with ``None`` every
hook reads its static value, bitwise the single-experiment path.

A padded step (mask 0) is a TRUE no-op: params and optimizer state are
kept by ``torch.where``, not merely fed a zero gradient, so weight decay,
momentum and Adam's count stay frozen.  The round loss is the mean over the
client's real steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ...core import federated
from ...core import tree as tree_util
from ...core.federated import lr_ratio, resolve
from ...core.state import make_client_optimizer
from ...models.base import TorchModel


@dataclasses.dataclass
class ServerCtx:
    """Server-side tensors a local round may read, shared by every client
    of the cohort.  Per-client state (SCAFFOLD c_i, FedDyn ∇̂_i) travels
    separately, as an input the cohort map batches."""
    global_params: Any = None
    c_server: Any = None          # SCAFFOLD server control variate
    server_momentum: Any = None   # Mime server momentum
    hparams: Any = None           # swept HParams of a population member


class ClientOut(NamedTuple):
    params: Any                   # stacked {name: (C, ...)} client params
    num_steps: torch.Tensor
    loss: torch.Tensor
    delta_c: Any = None           # SCAFFOLD Δc (server aggregate input)
    new_client_state: Any = None  # SCAFFOLD c_i⁺ / FedDyn ∇̂_i⁺
    tau: Any = None               # FedNova real steps
    grad_sum: Any = None          # FedNova / Mime / FedSGD mean gradient


def cross_entropy_loss(logits, labels):
    """Mean softmax cross-entropy, computed in f32: over the batch for
    (B, C) classification, over every position too for a (B, T, V) LM."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    return -torch.mean(ll)


def bce_elements(logits, targets):
    """Stable element-wise binary cross-entropy over multi-hot targets.
    At a logit of exactly 0 (a row without features at a zero bias) the
    gradient is the JAX package's: ``jnp.maximum`` splits a tie in half
    (``torch.maximum`` does too; ``clamp`` would not) and ``jnp.abs``
    takes slope 1 at 0 (the ``where`` below; ``abs`` takes 0), so there
    the gradient is −t rather than σ(0) − t."""
    l = logits.to(torch.float32)
    t = targets.to(torch.float32)
    abs_l = torch.where(l >= 0, l, -l)
    return (torch.maximum(l, torch.zeros_like(l)) - l * t
            + torch.log1p(torch.exp(-abs_l)))


def bce_with_logits(logits, targets):
    """Mean BCE: the tag-prediction loss."""
    return torch.mean(bce_elements(logits, targets))


def exact_match_hits(logits, targets):
    """Per example 0/1: the predicted tag set (logit > 0) equals the
    target set."""
    pred = (logits > 0).to(torch.float32)
    return torch.all(pred == targets.to(torch.float32),
                     dim=-1).to(torch.float32)


def exact_match(logits, targets):
    return torch.mean(exact_match_hits(logits, targets))


def accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, dim=-1) == labels)
                      .to(torch.float32))


#: the tasks the trainer runs: each picks its loss and evaluation
TASKS = ("classification", "lm", "tag_prediction")


class LocalTrainer:
    """Builds the pure per-client functions; owns no mutable state.
    ``algorithm`` (default: ``args.federated_optimizer``) selects the
    client-side hooks."""

    def __init__(self, model: TorchModel, args, algorithm=None):
        self.model = model
        self.args = args
        self.algorithm = federated.check_algorithm(
            algorithm or str(getattr(args, "federated_optimizer", "FedAvg")))
        if model.task not in TASKS:
            raise NotImplementedError(f"task {model.task!r} is not ported")
        self.tagpred = model.task == "tag_prediction"
        self.tx = make_client_optimizer(args)
        self.prox_mu = float(getattr(args, "fedprox_mu", 0.1))
        self.feddyn_alpha = float(getattr(args, "feddyn_alpha", 0.01))
        self.server_beta = float(getattr(args, "server_momentum", 0.9))
        self.lr = float(getattr(args, "learning_rate", 0.03))

    # -- loss ----------------------------------------------------------------
    def loss_fn(self, params, x, y, dropout_masks=None, ctx=None,
                client_state=None):
        """``client_state`` is FedDyn's ∇̂_i in the linear term (SCAFFOLD's
        c_i enters the gradient in :meth:`train_step` instead)."""
        logits = self.model.apply(params, x, train=True,
                                  dropout_masks=dropout_masks)
        loss = (bce_with_logits if self.tagpred else cross_entropy_loss)(
            logits, y)
        g = None if ctx is None else ctx.global_params
        hp = None if ctx is None else ctx.hparams
        if self.algorithm == "fedprox" and g is not None:
            mu = resolve(hp, "prox_mu", self.prox_mu)
            diff = tree_util.tree_sub(params, g)
            loss = loss + 0.5 * mu * tree_util.tree_sq_norm(diff)
        if self.algorithm == "feddyn" and g is not None:
            alpha = resolve(hp, "feddyn_alpha", self.feddyn_alpha)
            diff = tree_util.tree_sub(params, g)
            loss = loss + 0.5 * alpha * tree_util.tree_sq_norm(diff)
            if client_state is not None:
                loss = loss - tree_util.tree_dot(client_state, params)
        return loss

    # -- one step (pure) -----------------------------------------------------
    def grad_and_loss(self, params, x, y, dropout_masks=None, ctx=None,
                      client_state=None):
        """``(grads, loss)`` of one batch; the pipeline trainer
        (``simulation/mesh/pipeline.py``) computes its own."""
        return torch.func.grad_and_value(self.loss_fn)(
            params, x, y, dropout_masks, ctx, client_state)

    def train_step(self, carry, x, y, mask, dropout_masks=None, ctx=None):
        params, opt_state, c_client, gsum, nsteps, loss_acc = carry
        grads, loss = self.grad_and_loss(params, x, y, dropout_masks, ctx,
                                         c_client)
        if self.algorithm == "scaffold" and ctx.c_server is not None:
            grads = {k: g + ctx.c_server[k] - c_client[k]
                     for k, g in grads.items()}
        # mask BEFORE momentum/accumulation so a padded batch never leaks in
        grads = tree_util.tree_scale(grads, mask)
        step_grads = grads
        if self.algorithm == "mime" and ctx.server_momentum is not None:
            # MimeLite: (1−β)·g + β·m with the FIXED server momentum m
            b = self.server_beta
            step_grads = {k: (1 - b) * g + b * ctx.server_momentum[k]
                          for k, g in grads.items()}
        updates, new_opt = self.tx.update(step_grads, opt_state, params)
        # a swept client lr: every client optimizer ends in -lr·u, so
        # post-scaling by swept/static is the swept-lr step
        ratio = lr_ratio(None if ctx is None else ctx.hparams, "client_lr",
                         self.lr)
        if ratio is not None:
            updates = tree_util.tree_scale(updates, ratio)
        new_params = {k: p + updates[k] for k, p in params.items()}
        keep = mask > 0
        new_params = {k: torch.where(keep, v, params[k])
                      for k, v in new_params.items()}
        new_opt = {k: torch.where(keep, v, opt_state[k])
                   for k, v in new_opt.items()}
        if gsum is not None:
            gsum = tree_util.tree_add(gsum, grads)
        return (new_params, new_opt, c_client, gsum, nsteps + mask,
                loss_acc + loss * mask)

    # -- a client's whole round ----------------------------------------------
    def make_local_train(self):
        """Pure ``(global_params, xb, yb, mask, drop, ctx, client_state) ->
        {field: tensor}``, the :class:`ClientOut` fields the algorithm
        fills: ``xb``/``yb`` are ``(steps, batch, ...)``, ``mask`` is
        ``(steps,)`` of 0/1, ``drop`` the per-step dropout keep-masks (a
        tuple of ``(steps, batch, ...)``) or ``None``, ``ctx`` a
        :class:`ServerCtx`, ``client_state`` the client's SCAFFOLD c_i /
        FedDyn ∇̂_i or ``None`` (zeros)."""
        alg = self.algorithm
        needs_gsum = alg in ("fednova", "mime", "fedsgd")

        def local_train(global_params, xb, yb, mask, drop=None, ctx=None,
                        client_state=None):
            zero = torch.zeros((), dtype=torch.float32, device=mask.device)
            if client_state is None and alg in ("scaffold", "feddyn"):
                client_state = tree_util.tree_zeros_like(global_params)
            gsum = (tree_util.tree_zeros_like(global_params) if needs_gsum
                    else None)
            carry = (global_params, self.tx.init(global_params), client_state,
                     gsum, zero, zero)
            for s in range(xb.shape[0]):
                masks_s = None if drop is None else tuple(d[s] for d in drop)
                carry = self.train_step(carry, xb[s], yb[s], mask[s],
                                        masks_s, ctx)
            params, _, client_state, gsum, nsteps, loss_sum = carry
            hp = None if ctx is None else ctx.hparams
            out = {"params": params, "num_steps": nsteps,
                   "loss": loss_sum / torch.clamp(nsteps, min=1.0)}
            if alg == "scaffold":
                # c_i⁺ = c_i − c + (x − y_i)/(K·lr)  (SCAFFOLD eq. 4, II)
                K = torch.clamp(nsteps, min=1.0)
                lr = resolve(hp, "client_lr", self.lr)
                c_plus = {k: client_state[k] - ctx.c_server[k]
                          + (global_params[k] - params[k]) / (K * lr)
                          for k in params}
                out["delta_c"] = tree_util.tree_sub(c_plus, client_state)
                out["new_client_state"] = c_plus
            elif alg == "feddyn":
                # ∇̂_i⁺ = ∇̂_i − α·(θ_i − θ_global)
                alpha = resolve(hp, "feddyn_alpha", self.feddyn_alpha)
                out["new_client_state"] = {
                    k: client_state[k] - alpha
                    * (params[k] - global_params[k]) for k in params}
            if alg == "fednova":
                out["tau"] = nsteps
            if gsum is not None:
                # mean gradient over real steps (Mime's full-batch gradient
                # stand-in; FedSGD's round gradient)
                out["grad_sum"] = tree_util.tree_scale(
                    gsum, 1.0 / torch.clamp(nsteps, min=1.0))
            return out

        return local_train

    # -- evaluation ----------------------------------------------------------
    def make_eval_step(self):
        def eval_step(params, x, y, m):
            """Summed (loss, hits, count) over the valid examples of one
            batch; ``m`` (B,) masks the zero-padded ragged tail.  An
            example's loss and hit are its means over the tags (tag
            prediction: mean BCE, exact match) or over the positions (LM)
            first."""
            logits = self.model.apply(params, x, train=False)
            if self.tagpred:
                per = torch.mean(bce_elements(logits, y), dim=-1)
                hit = exact_match_hits(logits, y)
                return torch.sum(per * m), torch.sum(hit * m), torch.sum(m)
            logp = F.log_softmax(logits.to(torch.float32), dim=-1)
            ll = torch.gather(logp, -1, y[..., None])[..., 0]
            hit = (torch.argmax(logits, -1) == y).to(torch.float32)
            extra = tuple(range(m.ndim, ll.ndim))   # LM: the positions
            if extra:
                ll, hit = ll.mean(dim=extra), hit.mean(dim=extra)
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
