"""Deterministic synthetic LM data (numpy copy of
``fedml_tpu.data.synthetic.synthetic_lm_tokens`` — the only generator the
federated LoRA path needs)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core import hostrng


def synthetic_lm_tokens(
    train_n: int, test_n: int, vocab: int, seq_len: int, seed: int,
    order: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Markov-chain token sequences (for Shakespeare/StackOverflow-style LM
    workloads): a fixed sparse bigram transition matrix gives the model real
    structure to learn.  x = tokens[:-1]-style input, y = next-token target."""
    rng = hostrng.gen(seed, 0x71AB)
    # sparse-ish transition: each token strongly prefers ~4 successors
    succ = rng.integers(0, vocab, size=(vocab, 4))
    n = train_n + test_n
    seqs = np.zeros((n, seq_len + 1), dtype=np.int64)
    seqs[:, 0] = rng.integers(0, vocab, size=n)
    for t in range(seq_len):
        choice = rng.integers(0, 4, size=n)
        noise_tok = rng.integers(0, vocab, size=n)
        use_noise = rng.random(n) < 0.1
        nxt = succ[seqs[:, t], choice]
        seqs[:, t + 1] = np.where(use_noise, noise_tok, nxt)
    x, y = seqs[:, :-1], seqs[:, 1:]
    return x[:train_n], y[:train_n], x[train_n:], y[train_n:]
