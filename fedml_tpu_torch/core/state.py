"""Functional optimizers (port of
``fedml_tpu.core.state.make_client_optimizer``, and of the optax chains the
JAX package's server optimizers build).

The JAX package builds an optax chain; here the same arithmetic is written
once as pure tensor functions on ``{name: tensor}`` dicts, so a step can run
under ``torch.func.vmap`` and a padded step can keep the old state with a
``torch.where``.  Chain order is optax's:

- ``sgd``: global-norm clip (if ``clip_grad_norm``) → decayed weights
  (``g + wd·p``) → momentum trace (``t = g + m·t``) → ``−lr·t``;
- ``adam``: clip → Adam moments with bias correction (``b1``, ``b2``,
  ``eps``; optax's defaults 0.9, 0.999, 1e-8 for the client) → decayed
  weights (``adamw``, when ``wd``) → ``−lr·u``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

TensorDict = Dict[str, torch.Tensor]


def clip_by_global_norm(grads: TensorDict, max_norm: float) -> TensorDict:
    """optax's ``clip_by_global_norm``: every leaf ``(g / ‖g‖)·max_norm``
    when the global norm ``‖g‖ ≥ max_norm``, else unchanged (no epsilon,
    unlike ``clip_grad_norm_``, and no host sync: a ``where`` on the
    device)."""
    norm = torch.sqrt(sum(torch.sum(x * x) for x in grads.values()))
    keep = norm < max_norm
    return {k: torch.where(keep, x, (x / norm) * max_norm)
            for k, x in grads.items()}


class ClientOptimizer:
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, new_state)``; the new params are ``params + updates``.  The
    server optimizers of FedOpt are instances too."""

    def __init__(self, kind: str, lr: float, momentum: float = 0.0,
                 weight_decay: float = 0.0, clip: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if kind not in ("sgd", "adam"):
            raise ValueError(f"client_optimizer must be 'sgd' or 'adam', "
                             f"got {kind!r}")
        self.kind, self.lr, self.momentum = kind, lr, momentum
        self.wd, self.clip = weight_decay, clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: TensorDict) -> TensorDict:
        if self.kind == "adam":
            state = {f"mu/{k}": torch.zeros_like(v) for k, v in params.items()}
            state.update({f"nu/{k}": torch.zeros_like(v)
                          for k, v in params.items()})
            first = next(iter(params.values()))
            state["count"] = torch.zeros((), dtype=torch.int32,
                                         device=first.device)
            return state
        if self.momentum:
            return {f"trace/{k}": torch.zeros_like(v)
                    for k, v in params.items()}
        return {}

    def update(self, grads: TensorDict, state: TensorDict,
               params: TensorDict, lr: Optional[float] = None
               ) -> Tuple[TensorDict, TensorDict]:
        """``lr`` overrides the constructor's for this update (a
        schedule's value, read by the caller)."""
        lr = self.lr if lr is None else lr
        g = clip_by_global_norm(grads, self.clip) if self.clip > 0 else grads
        new_state = {}
        if self.kind == "sgd":
            if self.wd:
                g = {k: x + self.wd * params[k] for k, x in g.items()}
            if self.momentum:
                g = {k: x + self.momentum * state[f"trace/{k}"]
                     for k, x in g.items()}
                new_state = {f"trace/{k}": x for k, x in g.items()}
            return {k: (-lr) * x for k, x in g.items()}, new_state
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1
        bc1 = 1 - torch.pow(b1, count.to(torch.float32))
        bc2 = 1 - torch.pow(b2, count.to(torch.float32))
        u = {}
        for k, x in g.items():
            mu = (1 - b1) * x + b1 * state[f"mu/{k}"]
            nu = (1 - b2) * (x * x) + b2 * state[f"nu/{k}"]
            new_state[f"mu/{k}"], new_state[f"nu/{k}"] = mu, nu
            u[k] = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.wd:
                u[k] = u[k] + self.wd * params[k]
            u[k] = (-lr) * u[k]     # per leaf: no second copy of the tree
        new_state["count"] = count
        return u, new_state


def make_client_optimizer(args) -> ClientOptimizer:
    """The client optimizer from flat args (``client_optimizer``,
    ``learning_rate``, ``momentum``, ``weight_decay``, ``clip_grad_norm``)."""
    return ClientOptimizer(
        str(getattr(args, "client_optimizer", "sgd")).lower(),
        lr=float(getattr(args, "learning_rate", 0.03)),
        momentum=float(getattr(args, "momentum", 0.0) or 0.0),
        weight_decay=float(getattr(args, "weight_decay", 0.0) or 0.0),
        clip=float(getattr(args, "clip_grad_norm", 0.0) or 0.0))


def resolve_collective_precision(args, n_shards: int = 1) -> str:
    """``args.collective_precision`` for an engine on ``n_shards`` client
    shards (port of ``fedml_tpu.core.state.resolve_collective_precision``).

    ``fp32`` (default) keeps the collectives exact; ``bf16`` / ``int8``
    quantize the merge numerator (with error feedback) and the
    post-update broadcast while the server update keeps an fp32 master
    copy; ``auto`` picks bf16 when the payload crosses an interconnect
    (more than one shard) and fp32 otherwise."""
    mode = str(getattr(args, "collective_precision", "fp32")
               or "fp32").lower()
    if mode == "auto":
        return "bf16" if n_shards > 1 else "fp32"
    from .compression.blockscale import COLLECTIVE_PRECISIONS
    if mode not in COLLECTIVE_PRECISIONS:
        raise ValueError(
            f"collective_precision must be one of "
            f"{COLLECTIVE_PRECISIONS + ('auto',)}, got {mode!r}")
    return mode
