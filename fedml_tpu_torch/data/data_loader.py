"""``fedml_tpu_torch.data.load(args)`` — the language-model branch of
``fedml_tpu.data.data_loader.load``.

Only the ``_LM_SPECS`` datasets are ported, from the deterministic
Markov-chain generator (bitwise the JAX package's for the same seed and
sizes).  The readers of real data in ``args.data_cache_dir`` (``.npz``,
LEAF, the raw Shakespeare corpus) are not ported yet, so a cache directory
is refused rather than ignored.
"""

from __future__ import annotations

from typing import Tuple

from .federated_dataset import FederatedDataset, build_federated
from .synthetic import synthetic_lm_tokens

_LM_SPECS = {
    # vocab, seq_len, train_n, test_n
    "shakespeare": (90, 80, 16000, 2000),
    "fed_shakespeare": (90, 80, 16000, 2000),
    "stackoverflow_nwp": (10004, 20, 50000, 5000),
    "reddit": (10004, 20, 50000, 5000),
}


def _sizes(args, train_n: int, test_n: int) -> Tuple[int, int]:
    """Explicit ``args.train_size``/``test_size`` win over the defaults."""
    return (int(getattr(args, "train_size", 0) or train_n),
            int(getattr(args, "test_size", 0) or test_n))


def load(args) -> Tuple[FederatedDataset, int]:
    name = str(getattr(args, "dataset", "shakespeare")).lower()
    if name not in _LM_SPECS:
        raise ValueError(f"dataset {name!r} is not ported; the port loads "
                         f"the LM datasets {sorted(_LM_SPECS)}")
    if getattr(args, "data_cache_dir", None):
        raise NotImplementedError(
            "data_cache_dir is set, but the port reads no real data yet "
            "(synthetic LM data only): unset it")
    seed = int(getattr(args, "random_seed", 0))
    client_num = int(getattr(args, "client_num_in_total", 10))
    alpha = float(getattr(args, "partition_alpha", 0.5))
    vocab, seq_len, train_n, test_n = _LM_SPECS[name]
    seq_len = int(getattr(args, "seq_len", seq_len))
    train_n, test_n = _sizes(args, train_n, test_n)
    tx, ty, vx, vy = synthetic_lm_tokens(train_n, test_n, vocab, seq_len, seed)
    ds = build_federated(tx, ty, vx, vy, vocab, client_num, method="homo",
                         alpha=alpha, seed=seed, provenance="synthetic")
    return ds, vocab
