"""Non-IID partitioning — reference semantics from
``python/fedml/core/data/noniid_partition.py:87``
(``partition_class_samples_with_dirichlet_distribution``) and the
``partition_method: hetero`` / ``partition_alpha`` config keys
(``config/simulation_sp/fedml_config.yaml:13-14``).

Given labels, produce per-client index lists:
- ``homo``: random equal split.
- ``hetero``: per-class Dirichlet(alpha) proportions across clients, with the
  reference's balancing rule (clients already at capacity get zero share of a
  class batch) approximated by proportion renormalization.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .. import hostrng


def record_data_stats(y: np.ndarray, client_idxs: Dict[int, np.ndarray],
                      num_classes: int) -> Dict[int, List[int]]:
    """Per-client class histograms (reference ``record_net_data_stats``)."""
    return {
        c: np.bincount(np.asarray(y[idx], dtype=np.int64), minlength=num_classes).tolist()
        for c, idx in client_idxs.items()
    }


def partition_class_samples_with_dirichlet_distribution(
    N: int, alpha: float, client_num: int, idx_batch: List[List[int]],
    idx_k: np.ndarray, rng: np.random.Generator,
) -> tuple:
    """One class's sample indices distributed over clients by Dirichlet draw —
    same contract as the reference function (noniid_partition.py:87)."""
    rng.shuffle(idx_k)
    proportions = rng.dirichlet(np.repeat(alpha, client_num))
    # reference balancing: zero out clients that already hold >= N/client_num
    proportions = np.array(
        [p * (len(idx_j) < N / client_num) for p, idx_j in zip(proportions, idx_batch)]
    )
    s = proportions.sum()
    if s <= 0:
        proportions = np.repeat(1.0 / client_num, client_num)
    else:
        proportions = proportions / s
    cuts = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
    idx_batch = [idx_j + idx.tolist() for idx_j, idx in zip(idx_batch, np.split(idx_k, cuts))]
    min_size = min(len(idx_j) for idx_j in idx_batch)
    return idx_batch, min_size


def hetero_partition(y: np.ndarray, client_num: int, alpha: float,
                     seed: int = 0, min_require_size: int = 1) -> Dict[int, np.ndarray]:
    """Dirichlet LDA partition (the loop the reference repeats per dataset,
    e.g. ``data/cifar10/data_loader.py`` partition_data hetero branch)."""
    rng = hostrng.gen(seed, 0xD161)
    N = len(y)
    classes = np.unique(np.asarray(y))
    min_size = 0
    attempts = 0
    idx_batch: List[List[int]] = []
    while min_size < min_require_size:
        attempts += 1
        idx_batch = [[] for _ in range(client_num)]
        for k in classes:
            idx_k = np.where(np.asarray(y) == k)[0]
            idx_batch, min_size = partition_class_samples_with_dirichlet_distribution(
                N, alpha, client_num, idx_batch, idx_k, rng
            )
        if attempts >= 25 and min_size < min_require_size:
            # Dataset too small for client_num under the min-size constraint
            # (the reference's unguarded while-loop would spin forever here);
            # give empty clients one random sample each and move on.
            for idx_j in idx_batch:
                while len(idx_j) < min_require_size:
                    idx_j.append(int(rng.integers(0, N)))
            break
    return {c: np.sort(np.array(idx_batch[c], dtype=np.int64)) for c in range(client_num)}


def homo_partition(n: int, client_num: int, seed: int = 0) -> Dict[int, np.ndarray]:
    rng = hostrng.gen(seed, 0x4040)
    perm = rng.permutation(n)
    return {c: np.sort(chunk) for c, chunk in enumerate(np.array_split(perm, client_num))}


def partition(y: np.ndarray, client_num: int, method: str = "hetero",
              alpha: float = 0.5, seed: int = 0) -> Dict[int, np.ndarray]:
    if method in ("hetero", "dirichlet", "lda"):
        return hetero_partition(y, client_num, alpha, seed)
    return homo_partition(len(y), client_num, seed)
