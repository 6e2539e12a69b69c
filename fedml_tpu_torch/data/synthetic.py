"""Deterministic synthetic data (numpy copies of
``fedml_tpu.data.synthetic``): class-conditional Gaussian images for the
FedAvg path, class-dependent unigram token sequences for the FedNLP text
path, Markov-chain LM tokens for the LSTM and federated LoRA paths,
class-conditional Gaussian rows for the tabular sets, multi-hot tags
for Stack Overflow tag prediction, vertically split party features for
vertical FL and blocky per-pixel masks for segmentation, bitwise the JAX
package's for the same seed and sizes."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core import hostrng


def _class_gaussian_images(
    n: int, num_classes: int, shape: Tuple[int, ...], seed: int,
    noise: float = 0.35, latent_dim: int = 32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Class anchors in a latent space pushed through a fixed random affine
    map into pixel space, squashed to [0, 1]."""
    rng = hostrng.gen(seed, 0x5E7)
    dim = int(np.prod(shape))
    anchors = rng.standard_normal((num_classes, latent_dim)) * 2.0
    proj = rng.standard_normal((latent_dim, dim)) / np.sqrt(latent_dim)
    y = rng.integers(0, num_classes, size=n)
    z = anchors[y] + rng.standard_normal((n, latent_dim)) * noise
    x = z @ proj + rng.standard_normal((n, dim)) * (noise * 0.5)
    x = np.tanh(x * 0.5) * 0.5 + 0.5
    return x.reshape((n,) + shape).astype(np.float32), y.astype(np.int64)


def synthetic_image_classification(
    train_n: int, test_n: int, num_classes: int, shape: Tuple[int, ...],
    seed: int, noise: float = 0.35,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    x, y = _class_gaussian_images(train_n + test_n, num_classes, shape, seed,
                                  noise)
    return x[:train_n], y[:train_n], x[train_n:], y[train_n:]


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


def synthetic_text_classification(train_n: int, test_n: int, classes: int,
                                  vocab: int, seq_len: int, seed: int = 0,
                                  class_signal: float = 0.25,
                                  keyword_width: float = 2.5):
    """Class-dependent unigram token sequences (the 20news/agnews stand-in):
    a ``class_signal`` share of each document's tokens comes from its
    class's keyword window, ``keyword_width`` times the disjoint slice
    ``vocab // classes`` wide (so neighbouring classes share keywords and a
    Bayes-optimal unigram classifier cannot reach 1.0), the rest uniformly
    from the vocabulary.  Tokens int32, labels int64."""
    rng = np.random.default_rng(seed)
    stride = max(1, vocab // classes)
    width = max(1, int(round(keyword_width * stride)))

    def gen(n):
        y = rng.integers(0, classes, size=n)
        lo = (y * stride)[:, None]
        base = rng.integers(0, width, size=(n, seq_len))
        uniform = rng.integers(0, vocab, size=(n, seq_len))
        use_class = rng.random((n, seq_len)) < class_signal
        x = np.where(use_class, (lo + base) % vocab, uniform)
        return x.astype(np.int32), y.astype(np.int64)

    tx, ty = gen(train_n)
    vx, vy = gen(test_n)
    return tx, ty, vx, vy


def synthetic_tabular(train_n: int, test_n: int, classes: int,
                      n_features: int, seed: int = 0, noise: float = 0.6):
    """Class-conditional Gaussian rows (the UCI / lending-club stand-in)."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((classes, n_features))

    def gen(n):
        y = rng.integers(0, classes, size=n)
        x = means[y] + noise * rng.standard_normal((n, n_features))
        return x.astype(np.float32), y.astype(np.int64)

    tx, ty = gen(train_n)
    vx, vy = gen(test_n)
    return tx, ty, vx, vy


def synthetic_tag_prediction(train_n: int, test_n: int, n_tags: int,
                             n_features: int, seed: int = 0,
                             avg_tags: int = 3):
    """Multi-label tag prediction (the stackoverflow_lr stand-in): sparse
    bag-of-words rows, and as tags each tag whose score under a fixed random
    linear map passes its own threshold, calibrated so a tag fires on
    ~``avg_tags``/``n_tags`` of the rows (every tag linearly separable)."""
    rng = np.random.default_rng(seed)
    avg_tags = max(1, min(int(avg_tags), n_tags - 1)) if n_tags > 1 else 1
    w = rng.standard_normal((n_features, n_tags)) / np.sqrt(n_features)

    def features(n):
        return ((rng.random((n, n_features)) < 0.05)
                * rng.exponential(1.0, (n, n_features))).astype(np.float32)

    calib = features(2048) @ w
    thresh = np.quantile(calib, 1.0 - avg_tags / n_tags, axis=0)

    def gen(n):
        x = features(n)
        y = ((x @ w) >= thresh[None, :]).astype(np.float32)
        return x, y

    tx, ty = gen(train_n)
    vx, vy = gen(test_n)
    return tx, ty, vx, vy


def synthetic_vertical_parties(n: int, parties: int, features_per_party,
                               classes: int = 2, seed: int = 0,
                               noise: float = 0.5):
    """Vertically partitioned features (NUS-WIDE style: each party holds a
    different feature block of the SAME samples): ``(per-party arrays,
    labels)``."""
    rng = np.random.default_rng(seed)
    if isinstance(features_per_party, int):
        features_per_party = [features_per_party] * parties
    total = sum(features_per_party)
    means = rng.standard_normal((classes, total))
    y = rng.integers(0, classes, size=n)
    x = means[y] + noise * rng.standard_normal((n, total))
    outs, off = [], 0
    for f in features_per_party:
        outs.append(x[:, off:off + f].astype(np.float32))
        off += f
    return outs, y.astype(np.int64)


def synthetic_segmentation(train_n: int, test_n: int, num_classes: int,
                           shape, seed: int, noise: float = 0.1):
    """Dense per-pixel labels (the FeTS2021 / AutonomousDriving stand-in):
    blocky class regions, random label grids at a quarter of the size
    upsampled 4×, whose channel intensity encodes the class."""
    rng = np.random.default_rng(seed ^ 0x5E6)
    n = train_n + test_n
    h, w = int(shape[0]), int(shape[1])
    c = int(shape[2]) if len(shape) > 2 else 1
    gh, gw = max(1, h // 4), max(1, w // 4)
    grid = rng.integers(0, num_classes, size=(n, gh, gw))
    y = np.repeat(np.repeat(grid, (h + gh - 1) // gh, axis=1),
                  (w + gw - 1) // gw, axis=2)[:, :h, :w]
    x = (y[..., None] / max(num_classes - 1, 1)).astype(np.float32)
    x = np.broadcast_to(x, (n, h, w, c)).copy()
    x += noise * rng.standard_normal(x.shape).astype(np.float32)
    return (x[:train_n], y[:train_n].astype(np.int64),
            x[train_n:], y[train_n:].astype(np.int64))
