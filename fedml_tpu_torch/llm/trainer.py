"""Centralized causal-LM fine-tuning (port of ``fedml_tpu.llm.trainer``:
the reference's ``HFTrainer`` path, with its learning-rate schedules and
checkpoints), single device.

LoRA-only when ``lora_rank > 0`` (the adapters train, the base stays
frozen); otherwise dense, over f32 master weights.  The optimizer is
``optax.adamw`` chained after ``clip_by_global_norm(max_grad_norm)``, as the
JAX trainer builds it: the port's
:class:`~fedml_tpu_torch.core.state.ClientOptimizer` ("adam" with
``weight_decay`` and ``clip``), given the schedule's lr at each update.
That lr is read at the update count BEFORE it is incremented (the first
update after a warmup runs at lr 0).  ``optax.MultiSteps`` over
``gradient_accumulation_steps`` k: the micro-gradients are averaged (a
running mean), the inner update runs once per k, and the other micro-steps
leave the params and the inner state (counts included) untouched; a
partial accumulation carries across epochs.

An epoch visits ``np.random.default_rng(seed·1031 + epoch)``'s permutation
in whole batches; ``max_steps`` caps the inner updates.  Checkpoints
(``output_dir`` or ``checkpoint_dir``) are the port's own format
(:class:`~fedml_tpu_torch.core.checkpoint.RoundCheckpointer`).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..core import rng as rng_util
from ..core.state import ClientOptimizer
from ..device import get_device
from .fedllm import lora_init
from .model import LlamaLM, causal_nll, config_from_args, masked_nll

log = logging.getLogger(__name__)

_F32 = np.float32


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule(init, end, steps)`` in f32."""
    def schedule(count):
        frac = _F32(1) - _F32(min(max(count, 0), steps)) / _F32(steps)
        return _F32(init - end) * frac + _F32(end)
    return schedule


def make_lr_schedule(lr: float, kind: str, warmup_steps: int,
                     total_steps: int) -> Callable[[int], float]:
    """HF-style schedule as optax computes it (in f32): a linear warmup from
    0 to ``lr`` over ``warmup_steps``, then constant, linear to 0 or cosine
    to 0 over ``total_steps − warmup_steps`` (at least 1).  Returns
    ``count → lr`` as a Python float."""
    kind = str(kind).strip().lower()
    decay_steps = max(total_steps - warmup_steps, 1)
    if kind in ("constant", "constant_with_warmup", ""):
        body = lambda count: _F32(lr)
    elif kind == "linear":
        body = _linear(lr, 0.0, decay_steps)
    elif kind == "cosine":
        def body(count):
            c = min(_F32(count), _F32(decay_steps))
            cos = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * c
                                                / _F32(decay_steps)))
            return _F32(lr) * cos
    else:
        raise ValueError(f"unknown lr_scheduler_type {kind!r}; "
                         "one of constant|linear|cosine")
    if warmup_steps > 0:
        warm = _linear(0.0, lr, warmup_steps)
        return lambda count: float(warm(count) if count < warmup_steps
                                   else body(count - warmup_steps))
    return lambda count: float(body(count))


class CausalLMTrainer:
    """``train()`` → ``{"history": [{"epoch", "loss"}, ...]}``; the loss of
    every micro-step is kept in ``step_losses``.  ``device`` is the card
    unless the caller asks for the CPU.  ``mesh`` is accepted as the JAX
    trainer accepts it and never read, but for its device: the trainer
    runs on ``mesh.device``."""

    def __init__(self, args, dataset, device="cuda", mesh=None):
        self.args = args
        self.dataset = dataset
        self.mesh = mesh
        self.device = get_device(args, mesh.device if mesh is not None
                                 else device)
        self.seed = int(getattr(args, "random_seed", 0))
        self.batch_size = int(getattr(args, "batch_size", 4))
        self.epochs = int(getattr(args, "epochs", 1))
        self.lora_only = int(getattr(args, "lora_rank", 0)) > 0
        lr = float(getattr(args, "learning_rate", 1e-3))

        cfg = config_from_args(args, dataset.num_classes)
        if self.lora_only and cfg.lora_rank == 0:
            cfg = dataclasses.replace(
                cfg, lora_rank=int(getattr(args, "lora_rank", 8)),
                lora_alpha=float(getattr(args, "lora_alpha", 16.0)))
        if not self.lora_only and cfg.param_dtype is None:
            # the base trains: f32 masters (bf16 storage rounds away AdamW
            # updates below ~2^-9 relative)
            cfg = dataclasses.replace(cfg, param_dtype=torch.float32)
        self.cfg = cfg
        key = rng_util.root_key(self.seed, self.device)
        with torch.device(self.device):
            self.model = LlamaLM(cfg, trainable=not self.lora_only)
        self.model.init_weights(rng_util.purpose_key(key, "init"))
        if self.lora_only:
            self.lora = lora_init(rng_util.purpose_key(key, "lora"),
                                  self.model.lora_shapes(), self.device)
        else:
            self.lora = None

        self.accum_steps = max(1, int(getattr(
            args, "gradient_accumulation_steps", 1)))
        micro_per_epoch = max(1, len(dataset.train_x) // self.batch_size)
        # the accumulation carries across epochs: updates floor over the run
        run_updates = (self.epochs * micro_per_epoch) // self.accum_steps
        self.max_updates = int(getattr(args, "max_steps", 0) or 0)
        total_updates = max(self.max_updates or run_updates, 1)
        self.lr_schedule = make_lr_schedule(
            lr, str(getattr(args, "lr_scheduler_type", "constant")),
            int(getattr(args, "warmup_steps", 0)), total_updates)
        self.tx = ClientOptimizer(
            "adam", lr, weight_decay=float(getattr(args, "weight_decay", 0.0)),
            clip=float(getattr(args, "max_grad_norm", 0.0) or 0.0))
        tree = self._train_tree()
        #: AdamW's state and MultiSteps' accumulator
        self.opt = {"adam": self.tx.init(tree),
                    "acc": ({k: torch.zeros_like(v) for k, v in tree.items()}
                            if self.accum_steps > 1 else {})}
        #: inner updates so far (the schedule's count; Adam keeps its own,
        #: always equal) and micro-steps accumulated
        self.counts = {"updates": 0, "mini_step": 0}
        self.global_step = 0
        self.step_losses = []

    # -- the trained tree ----------------------------------------------------
    def _train_tree(self) -> Dict[str, torch.Tensor]:
        """The adapters (LoRA-only) or the module's own parameters."""
        if self.lora_only:
            return self.lora
        return dict(self.model.named_parameters())

    def _loss_and_grads(self, x, y):
        tree = self._train_tree()
        keys = list(tree)
        if self.lora_only:
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in tree.items()}
            loss = causal_nll(self.model(x, leaves), y)
            grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        else:
            loss = causal_nll(self.model(x), y)
            grads = torch.autograd.grad(loss, [tree[k] for k in keys])
        return loss.detach(), dict(zip(keys, grads))

    @torch.no_grad()
    def _inner_update(self, grads) -> None:
        """clip → AdamW → apply, on the trained tree."""
        lr = self.lr_schedule(self.counts["updates"])
        self.counts["updates"] += 1
        tree = self._train_tree()
        updates, self.opt["adam"] = self.tx.update(grads, self.opt["adam"],
                                                   tree, lr=lr)
        if self.lora_only:
            self.lora = {k: p + updates[k] for k, p in tree.items()}
        else:
            for k, p in tree.items():
                p.add_(updates[k])

    def _step(self, x, y):
        loss, grads = self._loss_and_grads(x, y)
        if self.accum_steps == 1:
            self._inner_update(grads)
            return loss
        n = self.counts["mini_step"]
        acc = self.opt["acc"]
        with torch.no_grad():
            for k, g in grads.items():
                acc[k] = acc[k] + (g - acc[k]) / (n + 1)
        if n == self.accum_steps - 1:
            self._inner_update(acc)
            self.opt["acc"] = {k: torch.zeros_like(v) for k, v in acc.items()}
            self.counts["mini_step"] = 0
        else:
            self.counts["mini_step"] = n + 1
        return loss

    def train(self) -> Dict[str, Any]:
        n = len(self.dataset.train_x)
        steps = n // self.batch_size
        history = []
        for epoch in range(self.epochs):
            rng = np.random.default_rng(self.seed * 1031 + epoch)
            order = rng.permutation(n)[: steps * self.batch_size]
            xb = self.dataset.train_x[order].reshape(
                steps, self.batch_size, -1)
            yb = self.dataset.train_y[order].reshape(
                steps, self.batch_size, -1)
            t0 = time.time()
            losses = []
            budget_hit = False
            for s in range(steps):
                if (self.max_updates and self.global_step // self.accum_steps
                        >= self.max_updates):
                    budget_hit = True
                    break
                losses.append(self._step(
                    torch.as_tensor(xb[s], device=self.device),
                    torch.as_tensor(yb[s], device=self.device)))
                self.global_step += 1
            if not losses:
                if budget_hit:
                    break
                continue
            stacked = torch.stack(losses)
            self.step_losses += stacked.tolist()
            mean_loss = float(stacked.mean())
            log.info("epoch %d: loss=%.4f (%.1fs)", epoch, mean_loss,
                     time.time() - t0)
            history.append({"epoch": epoch, "loss": mean_loss})
            self.save_checkpoint()
            if budget_hit:
                log.info("max_steps=%d update budget reached at epoch %d",
                         self.max_updates, epoch)
                break
        return {"history": history}

    @torch.no_grad()
    def evaluate(self) -> float:
        nll, cnt = masked_nll(self.model, self.lora,
                              *self.dataset.test_batches(
                                  batch_size=self.batch_size), self.device)
        return float(nll / cnt)

    # -- checkpointing -------------------------------------------------------
    def _checkpointer(self):
        out = getattr(self.args, "output_dir", None) or \
            getattr(self.args, "checkpoint_dir", None)
        if not out:
            return None
        if not hasattr(self, "_ckpt"):
            from ..core.checkpoint import RoundCheckpointer
            self._ckpt = RoundCheckpointer(str(out))
        return self._ckpt

    def _state(self) -> Dict[str, torch.Tensor]:
        """The trained tree and the optimizer state as one flat dict."""
        state = {f"train/{k}": v for k, v in self._train_tree().items()}
        for part, tree in self.opt.items():
            state.update({f"opt/{part}/{k}": v for k, v in tree.items()})
        state.update({f"count/{k}": torch.tensor(v)
                      for k, v in self.counts.items()})
        return state

    def save_checkpoint(self) -> None:
        ckpt = self._checkpointer()
        if ckpt is not None:
            ckpt.save(self.global_step, self._state())

    def resume_from_checkpoint(self) -> bool:
        ckpt = self._checkpointer()
        if ckpt is None or ckpt.latest_round() is None:
            return False
        state, _ = ckpt.restore(template=(self._state(), None))
        train = {k[len("train/"):]: v for k, v in state.items()
                 if k.startswith("train/")}
        if self.lora_only:
            self.lora = train
        else:
            with torch.no_grad():
                for k, p in self.model.named_parameters():
                    p.copy_(train[k])
        for part in self.opt:
            pre = f"opt/{part}/"
            self.opt[part] = {k[len(pre):]: v for k, v in state.items()
                              if k.startswith(pre)}
        self.counts = {k: int(state[f"count/{k}"]) for k in self.counts}
        self.global_step = int(ckpt.latest_round())
        log.info("resumed at step %d", self.global_step)
        return True

    def close(self) -> None:
        if hasattr(self, "_ckpt"):
            self._ckpt.close()
            del self._ckpt
