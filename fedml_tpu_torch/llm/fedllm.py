"""Federated LoRA fine-tuning of a causal LM (port of
``fedml_tpu.llm.fedllm``, single-device path).

ONE copy of the frozen base weights lives in :class:`LlamaLM`; per-client
state is only the flat LoRA adapter dict.  A round runs the cohort's
clients one after another against the shared base (the JAX package vmaps
them; each client's numbers are the same either way), then merges the
adapters by a per-rank-component weighted average.

The local optimizer is Adam as ``optax.adamw(lr, weight_decay=0)`` computes
it, written as a functional update on the adapter dict: a step whose mask
is 0 leaves the adapters AND the optimizer state (step count included)
exactly as they were, so such a step is skipped outright.

With ``streaming_xent_chunk > 0`` the loss is the vocab-chunked
cross-entropy of :mod:`..ops.xent` over the model's final hidden states
(the chunk clamped to the vocabulary), which never holds the logits.  MoE
models (``n_experts``) come through the config.

``mesh=`` (a :class:`~fedml_tpu_torch.core.mesh.Mesh` of ``c × m``
ranks, the counterpart of the JAX package's GSPMD mesh regime) runs the
round over the ranks of the process group.  Each model group of ``m``
ranks holds one tensor-parallel base (``LlamaLM(cfg, mesh=mesh)``: this
rank's shards, materialized from the meta device, never whole on one
card) and trains one client at a time, the attention through K1–K3 on the
rank's own heads; the adapters stay whole on every rank, their gradients
summed over the model group, so the group's ranks hold the same adapters.
The cohort is padded on the host to a multiple of the client factor ``c``
(zero weight, no rank components, every step masked) and each group
trains its contiguous block of clients; the weighted adapter merge is one
all-reduce over the client axis of the numerators, the per-component
weights and the loss.  A mesh made with a model factor of 1
(``make_mesh2d("c,1")``) runs the same code, its model-group collectives
the identity; the 1-D client mesh (``make_mesh()``, no model group) keeps
one whole base on every rank.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core import rng as rng_util
from ..core import tree as tree_util
from ..data.federated_dataset import FederatedDataset
from ..ops.xent import streaming_xent
from .model import LlamaLM, causal_nll, config_from_args, masked_nll

log = logging.getLogger(__name__)

LoRA = Dict[str, torch.Tensor]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def lora_init(generator: torch.Generator, lora_shapes: Dict[str, tuple],
              device) -> LoRA:
    """Every 'A' leaf N(0, 0.02²) from ``generator``, every 'B' zero:
    adapters start as the identity."""
    out = {}
    for path, shape in lora_shapes.items():
        if path.endswith("/A"):
            out[path] = 0.02 * torch.randn(shape, generator=generator,
                                           device=device, dtype=torch.float32)
        else:
            out[path] = torch.zeros(shape, device=device, dtype=torch.float32)
    return out


def rank_mask_tree(lora_template: LoRA, mask_vec: torch.Tensor) -> LoRA:
    """Per-leaf masks zeroing every rank component a client does not hold:
    'A' leaves ``(in, R)`` mask the last axis, 'B' leaves ``(R, out)`` the
    first.  ``mask_vec`` is the client's ``(R,)`` 0/1 vector."""
    out = {}
    for path, leaf in lora_template.items():
        if path.endswith("/A"):
            out[path] = mask_vec[None, :].to(leaf.dtype)
        else:
            out[path] = mask_vec[:, None].to(leaf.dtype)
    return out


class FedLLMAPI:
    """FedAvg over LoRA adapters of a causal LM."""

    def __init__(self, args, dataset: FederatedDataset, device="cuda",
                 mesh=None):
        if mesh is not None:
            bad = {a: n for a, n in mesh.shape.items()
                   if a not in ("client", "model") and n > 1}
            if bad:
                raise NotImplementedError(
                    f"FedLLMAPI(mesh=...) with mesh axes {bad}: only the "
                    "client x model mesh is ported")
            device = mesh.device
        self.mesh = mesh
        self.args = args
        self.dataset = dataset
        self.device = torch.device(device)
        self.seed = int(getattr(args, "random_seed", 0))
        self.batch_size = int(getattr(args, "batch_size", 2))
        self.epochs = int(getattr(args, "epochs", 1))
        self.comm_rounds = int(getattr(args, "comm_round", 5))
        self.clients_per_round = int(getattr(args, "client_num_per_round", 4))
        self.max_steps = int(getattr(args, "llm_max_local_steps", 4))
        self.lr = float(getattr(args, "learning_rate", 1e-3))

        cfg = config_from_args(args, dataset.num_classes)
        if cfg.lora_rank == 0:
            import dataclasses
            cfg = dataclasses.replace(
                cfg, lora_rank=int(getattr(args, "lora_rank", 8)),
                lora_alpha=float(getattr(args, "lora_alpha", 16.0)))
        self.cfg = cfg
        # a chunk wider than the vocabulary would pad the head product
        self.xent_chunk = min(int(cfg.streaming_xent_chunk or 0),
                              cfg.vocab_size)
        if self.xent_chunk and mesh is not None and mesh.model_size > 1:
            raise NotImplementedError(
                "streaming_xent_chunk with a model factor above 1: the "
                "vocab-chunked loss over a row-parallel lm_head is not "
                "ported")

        # heterogeneous adapter capacity (HetLoRA-style): device classes
        # train different ranks of the same global adapters
        ranks = getattr(args, "lora_rank_per_client", None)
        self.client_ranks = None
        if ranks is not None:
            ranks = np.asarray(ranks, np.int32)
            if len(ranks) != dataset.num_clients:
                raise ValueError(
                    f"lora_rank_per_client has {len(ranks)} entries for "
                    f"{dataset.num_clients} clients")
            if ranks.min() < 1 or ranks.max() > cfg.lora_rank:
                raise ValueError(
                    f"per-client ranks must be in [1, {cfg.lora_rank}], "
                    f"got [{ranks.min()}, {ranks.max()}]")
            self.client_ranks = ranks

        key = rng_util.root_key(self.seed, self.device)
        #: the mesh whose model group runs the tensor-parallel base
        self._tp = mesh if mesh is not None and "model" in mesh.groups \
            else None
        if self._tp is None:
            self.model = LlamaLM(cfg).to(self.device)
        else:
            # this rank's shards only, straight onto the device
            with torch.device("meta"):
                model = LlamaLM(cfg, mesh=mesh)
            self.model = model.to_empty(device=self.device)
        self.model.init_weights(rng_util.purpose_key(key, "init"))
        self.global_lora = lora_init(rng_util.purpose_key(key, "lora"),
                                     self.model.lora_shapes(), self.device)
        #: per-round {"round", "train_loss", "steps", "seconds"} records
        #: of train()
        self.history = []

    # -- local training ---------------------------------------------------
    def loss(self, lora: LoRA, x, y):
        """Mean token NLL of one batch under ``lora``: dense logits, or the
        streaming cross-entropy when ``streaming_xent_chunk`` is set."""
        if self.xent_chunk:
            h = self.model(x, lora, return_hidden=True)
            return streaming_xent(h, self.model.lm_head.kernel, y,
                                  self.xent_chunk)
        return causal_nll(self.model(x, lora), y)

    def _local_train(self, lora0: LoRA, xb, yb, mask: np.ndarray,
                     rank_vec: torch.Tensor):
        """One client's local Adam steps over its real steps (``mask`` is 1
        there, 0 on padding).  Returns (adapters, mean loss over its real
        steps)."""
        mtree = rank_mask_tree(lora0, rank_vec)
        lora = tree_util.tree_map(torch.mul, lora0, mtree)
        mu = tree_util.tree_zeros_like(lora)
        nu = tree_util.tree_zeros_like(lora)
        count = 0
        losses = []
        keys = list(lora)
        for s in range(len(mask)):
            if mask[s] <= 0:
                continue      # masked: adapters and optimizer state unchanged
            params = {k: lora[k].detach().requires_grad_(True) for k in keys}
            x = torch.as_tensor(xb[s], device=self.device)
            y = torch.as_tensor(yb[s], device=self.device)
            loss = self.loss(params, x, y)
            grads = torch.autograd.grad(loss, [params[k] for k in keys])
            if self._tp is not None:
                # each rank holds its heads' and columns' part
                grads = self._tp.psum_many(grads, axis="model")
            count += 1
            bc1 = 1.0 - _B1 ** count
            bc2 = 1.0 - _B2 ** count
            with torch.no_grad():
                for k, g in zip(keys, grads):
                    g = g * mtree[k]
                    mu[k] = (1 - _B1) * g + _B1 * mu[k]
                    nu[k] = (1 - _B2) * (g * g) + _B2 * nu[k]
                    upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + _EPS)
                    lora[k] = lora[k] + (-self.lr) * upd
            losses.append(loss.detach())
        if not losses:
            return lora, torch.zeros((), device=self.device)
        return lora, torch.stack(losses).mean()

    def _cohort_rank_masks(self, clients) -> np.ndarray:
        """(C, R) 0/1 masks: which rank components each sampled client
        holds (all ones when ranks are homogeneous)."""
        R = self.cfg.lora_rank
        if self.client_ranks is None:
            return np.ones((len(clients), R), np.float32)
        ranks = self.client_ranks[np.asarray(clients)]
        return (np.arange(R)[None, :] < ranks[:, None]).astype(np.float32)

    def train_one_round(self, round_idx: int):
        clients = rng_util.sample_clients(self.seed, round_idx,
                                          self.dataset.num_clients,
                                          self.clients_per_round)
        rank_masks = torch.as_tensor(self._cohort_rank_masks(clients),
                                     device=self.device)
        x, y, mask, w = self.dataset.cohort_batches(
            clients, self.batch_size, self.seed, round_idx, self.epochs,
            max_steps=self.max_steps)
        rows = slice(0, len(clients))
        if self.mesh is not None:
            # host-pad to the client factor, then this model group's block
            from ..core.mesh import pad_to_multiple
            groups = self.mesh.client_size
            pad = pad_to_multiple(len(clients), groups) - len(clients)
            padc = lambda a: np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))
            x, y, mask, w = padc(x), padc(y), padc(mask), padc(w)
            rank_masks = torch.cat([rank_masks, rank_masks.new_zeros(
                (pad, rank_masks.shape[1]))])
            per = len(w) // groups
            c = self.mesh.c_coord
            rows = slice(c * per, (c + 1) * per)
        loras, losses = [], []
        for c in range(rows.start, rows.stop):
            lora_c, loss_c = self._local_train(self.global_lora, x[c], y[c],
                                               mask[c], rank_masks[c])
            loras.append(lora_c)
            losses.append(loss_c)
        weights = torch.as_tensor(w[rows], device=self.device)
        self.global_lora, round_loss = self._merge(
            loras, rank_masks[rows], weights, torch.stack(losses))
        # "steps": the real (unmasked) local steps the cohort took
        return {"train_loss": float(round_loss), "steps": int(mask.sum())}

    def _merge(self, loras, rank_masks, weights, losses):
        """The merged adapters and the round's weighted loss.  Each rank
        component averages over the clients that hold it; a component
        nobody in the cohort holds keeps its global value.  On a mesh the
        numerators, the component weights and the loss sums of this model
        group's clients travel in one all-reduce over the client axis."""
        parts = {}
        for k, g in self.global_lora.items():
            stacked = torch.stack([l[k] for l in loras])
            m = torch.stack([rank_mask_tree({k: g}, rv)[k]
                             for rv in rank_masks])
            wm = weights.reshape((-1,) + (1,) * g.dim()) * m.expand_as(stacked)
            parts[k] = ((stacked * wm).sum(0), wm.sum(0))
        loss_sums = torch.stack([(losses * weights).sum(), weights.sum()])
        if self.mesh is not None:
            names = list(parts)
            *summed, loss_sums = self.mesh.psum_many(
                [t for k in names for t in parts[k]] + [loss_sums],
                axis="client")
            parts = {k: (summed[2 * i], summed[2 * i + 1])
                     for i, k in enumerate(names)}
        merged = {}
        for k, (num, tot) in parts.items():
            avg = num / torch.clamp_min(tot, 1e-12)
            merged[k] = torch.where(tot > 0, avg, self.global_lora[k])
        return merged, loss_sums[0] / loss_sums[1]

    # -- evaluation ---------------------------------------------------------
    @torch.no_grad()
    def evaluate(self) -> float:
        nll, n = masked_nll(self.model, self.global_lora,
                            *self.dataset.test_batches(
                                batch_size=self.batch_size), self.device)
        return float(nll / n)

    @torch.no_grad()
    def evaluate_per_client(self, batch_size: Optional[int] = None):
        """The global adapters scored on every client's local sequences:
        per-client mean NLL and its mean, std, max (the worst-served
        client) and 90th percentile."""
        bs = int(batch_size or self.batch_size)
        clients, X, Y, M = self.dataset.pack_per_client(bs)
        nlls = []
        for xb, yb, mb in zip(X, Y, M):
            nll, n = masked_nll(self.model, self.global_lora, xb, yb, mb,
                                self.device)
            nlls.append(nll / torch.clamp_min(n, 1.0))
        nlls = torch.stack(nlls).cpu().numpy()
        return {
            "clients": clients,
            "per_client_nll": nlls,
            "nll_mean": float(nlls.mean()),
            "nll_std": float(nlls.std()),
            "nll_max": float(nlls.max()),
            "nll_p90": float(np.percentile(nlls, 90)),
        }

    def train(self) -> LoRA:
        for r in range(self.comm_rounds):
            t0 = time.time()
            m = self.train_one_round(r)
            dt = time.time() - t0
            self.history.append(dict(m, round=r, seconds=dt))
            log.info("fedllm round %d: loss=%.4f (%.2fs)", r,
                     m["train_loss"], dt)
        return self.global_lora
