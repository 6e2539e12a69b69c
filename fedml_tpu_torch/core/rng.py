"""Deterministic randomness for federated simulation (port of
``fedml_tpu.core.rng``).

Host-side sampling is the numpy Philox stream of :mod:`.hostrng`, bitwise
the JAX package's.  Device randomness is a seeded ``torch.Generator`` per
purpose: ``purpose_key`` derives a child seed from the parent's seed and a
string tag, so every purpose gets its own stream regardless of call order.
Threefry bits are not reproducible in PyTorch, so parity with the JAX
package comes from carrying its weights across (``llm/convert.py``), not
from matching random draws.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import hostrng

_SEED_MASK = (1 << 63) - 1


def root_key(seed: int, device="cpu") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & _SEED_MASK)
    return g


def _child(key: torch.Generator, word: int) -> torch.Generator:
    g = torch.Generator(device=key.device)
    g.manual_seed(hostrng._splitmix64(key.initial_seed() ^ word) & _SEED_MASK)
    return g


def child_key(key: torch.Generator, word: int) -> torch.Generator:
    """Child generator of ``key`` for an integer word, independent of how
    far ``key`` has been drawn (it derives from the initial seed)."""
    return _child(key, int(word))


def purpose_key(key: torch.Generator, purpose: str) -> torch.Generator:
    """Child generator for a string purpose tag ("init", "lora", ...)."""
    tag = int.from_bytes(hashlib.sha256(purpose.encode()).digest()[:4],
                         "little")
    return _child(key, tag)


def round_key(key: torch.Generator, round_idx: int) -> torch.Generator:
    """Child generator of one round (the round's device randomness, e.g.
    dropout keep-masks), independent of every other round's."""
    return _child(purpose_key(key, "round"), int(round_idx))


def client_key(key: torch.Generator, round_idx: int,
               client_idx: int) -> torch.Generator:
    """Child generator of one client in one round (the async engine's
    per-client draws), independent of every other (round, client)."""
    return _child(round_key(key, round_idx), int(client_idx))


def sample_clients(seed: int, round_idx: int, num_clients: int,
                   clients_per_round: int) -> np.ndarray:
    """Per-round client sampling, host-side: every client if they all fit,
    else a sorted draw without replacement from the (seed, round) stream."""
    if num_clients <= clients_per_round:
        return np.arange(num_clients)
    rng = hostrng.gen(seed, round_idx, 0xC11E)
    return np.sort(rng.choice(num_clients, clients_per_round, replace=False))
