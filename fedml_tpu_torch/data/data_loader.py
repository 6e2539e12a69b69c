"""``fedml_tpu_torch.data.load(args)`` — the dataset dispatcher of
``fedml_tpu.data.data_loader.load``, for the branches the port runs:

- the image datasets (``_IMAGE_SPECS``: mnist, femnist, cifar, ...): a LEAF
  layout, an ``.npz``, MNIST idx files or CIFAR archives under
  ``args.data_cache_dir`` when present, else the synthetic generator at the
  reference cardinality (``train_size``/``test_size`` override it);
- the LM datasets (``_LM_SPECS``: shakespeare, stackoverflow_nwp, ...): a
  LEAF layout (its natural per-user partition), then ``<name>.npz``, then
  for Shakespeare the raw corpus ``shakespeare.txt`` (in the cache, under
  ``<name>/`` or ``shakespeare/``), else the Markov-chain generator;
- tag prediction (``_TAGPRED_SPECS``: stackoverflow_lr): a multi-hot
  ``.npz``, else the synthetic generator (capped at 5,000 / 500 rows, 100
  tags, 1,000 features unless ``train_size``/``test_size``/``tag_count``/
  ``feature_dim`` say otherwise), partitioned by each row's first tag; it
  sets ``args.input_shape`` and ``args.task_type = "tag_prediction"``;
- the tabular sets (``_TABULAR_SPECS``: uci, lending_club, ...): an
  ``.npz``, else class-conditional Gaussian rows;
- ``breast_cancer``, ``wine`` and ``uci_real``: sklearn's bundled tables,
  standardised with the train split's statistics (sklearn is imported only
  here);
- ``digits``: the committed LEAF shard in the cache first, else sklearn's
  digits as in the JAX package;
- the generic ``synthetic*`` datasets;
- the text-classification datasets (``_TEXTCLS_SPECS``: fednlp, 20news,
  agnews, realtext): an ``<name>.npz`` under ``args.data_cache_dir`` (the
  committed ``data_shards/realtext`` shard), else the seeded unigram
  generator; ``vocab_size``, ``seq_len``, ``train_size``, ``test_size``,
  ``text_class_signal`` and ``text_keyword_width`` override the spec;
- the segmentation sets (``_SEG_SPECS``: fets2021, fets,
  autonomous_driving, cityscapes): an ``.npz`` with (N, H, W) label masks,
  else blocky synthetic masks, partitioned by each image's dominant class.

:func:`load_vertical` gives vertical FL its party feature blocks.  Every
array is bitwise the JAX package's for the same arguments.  The other
dataset families (large images, edge cases) raise, naming themselves.
"""

from __future__ import annotations

import gzip
import os
import re
import struct
from typing import Optional, Tuple

import numpy as np

from ..core.data.noniid_partition import partition
from .federated_dataset import FederatedDataset, build_federated
from .leaf import find_leaf_root, load_leaf, load_shakespeare_raw
from .synthetic import (synthetic_image_classification, synthetic_lm_tokens,
                        synthetic_segmentation, synthetic_tabular,
                        synthetic_tag_prediction,
                        synthetic_text_classification,
                        synthetic_vertical_parties)

# (classes, img shape, train_n, test_n), the reference cardinalities
_IMAGE_SPECS = {
    "mnist": (10, (28, 28, 1), 60000, 10000),
    "synthetic_mnist": (10, (28, 28, 1), 60000, 10000),
    "femnist": (62, (28, 28, 1), 60000, 10000),
    "fashionmnist": (10, (28, 28, 1), 60000, 10000),
    "emnist": (62, (28, 28, 1), 60000, 10000),
    "cifar10": (10, (32, 32, 3), 50000, 10000),
    "cifar100": (100, (32, 32, 3), 50000, 10000),
    "fed_cifar100": (100, (32, 32, 3), 50000, 10000),
    "cinic10": (10, (32, 32, 3), 90000, 90000),
}

_LM_SPECS = {
    # vocab, seq_len, train_n, test_n
    "shakespeare": (90, 80, 16000, 2000),
    "fed_shakespeare": (90, 80, 16000, 2000),
    "stackoverflow_nwp": (10004, 20, 50000, 5000),
    "reddit": (10004, 20, 50000, 5000),
}

# multi-label tag prediction: (n_tags, n_features, ref_train_n, ref_test_n)
_TAGPRED_SPECS = {
    "stackoverflow_lr": (500, 10000, 50000, 5000),
}

# tabular sets: (classes, n_features, train_n, test_n)
_TABULAR_SPECS = {
    "uci": (2, 14, 30000, 5000),
    "uci_adult": (2, 14, 30000, 5000),
    "lending_club": (2, 20, 40000, 8000),
    "lending_club_loan": (2, 20, 40000, 8000),
}

_TEXTCLS_SPECS = {
    # classes, vocab, seq_len, train_n, test_n, class_signal, keyword_width
    "fednlp": (20, 30000, 128, 11000, 2000, 0.25, 2.5),
    "20news": (20, 30000, 128, 11000, 2000, 0.25, 2.5),
    "agnews": (4, 30000, 64, 12000, 2000, 0.35, 2.0),
    # real bytes in the repo: installed-package documentation prose
    # (data_shards/realtext/realtext.npz); the knobs serve the fallback only
    "realtext": (10, 8192, 128, 2967, 530, 0.25, 2.5),
}

# dense-prediction sets (FeTS2021: 4-modality MRI tumour segmentation;
# AutonomousDriving: driving scenes): (classes, (H, W, C), train_n, test_n)
_SEG_SPECS = {
    "fets2021": (4, (64, 64, 4), 2000, 400),
    "fets": (4, (64, 64, 4), 2000, 400),
    "autonomous_driving": (19, (64, 128, 3), 3000, 500),
    "cityscapes": (19, (64, 128, 3), 3000, 500),
}

#: dataset families of the JAX loader the port does not load yet
_UNPORTED = {
    "imagenet": "large image", "imagenet_hdf5": "large image",
    "ilsvrc2012": "large image", "landmarks": "large image",
    "gld23k": "large image", "gld160k": "large image",
    "edge_case_examples": "edge case", "edge_case": "edge case",
}


def _cache_provenance(root: str, default: str,
                      name: Optional[str] = None) -> str:
    """Lineage of cache-resident files: a ``PROVENANCE.<name>`` marker, or a
    bare ``PROVENANCE`` marker whose tag names ``name`` as a token, wins;
    otherwise ``default`` (a ``real:*`` tag)."""
    candidates = [f"PROVENANCE.{name}"] if name else []
    candidates.append("PROVENANCE")
    for fname in candidates:
        try:
            with open(os.path.join(root, fname)) as f:
                tag = f.read().strip()
        except OSError:
            continue
        if not tag:
            continue
        if fname == "PROVENANCE" and name and \
                name not in re.split(r"[^a-z0-9_]+", tag.lower()):
            continue
        return tag
    return default


def _try_load_npz(cache_dir: str, name: str):
    path = os.path.join(cache_dir, f"{name}.npz")
    if os.path.exists(path):
        d = np.load(path)
        return d["train_x"], d["train_y"], d["test_x"], d["test_y"]
    return None


def _try_load_mnist_idx(cache_dir: str):
    """Classic idx-ubyte MNIST files, optionally gzipped."""
    def read_idx(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, = struct.unpack(">H", f.read(4)[2:])
            ndim = magic & 0xFF
            dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
            return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)

    base = os.path.join(cache_dir, "MNIST", "raw")
    names = ["train-images-idx3-ubyte", "train-labels-idx1-ubyte",
             "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"]
    found = []
    for n in names:
        for cand in (os.path.join(base, n), os.path.join(base, n + ".gz"),
                     os.path.join(cache_dir, n),
                     os.path.join(cache_dir, n + ".gz")):
            if os.path.exists(cand):
                found.append(cand)
                break
    if len(found) != 4:
        return None
    tx, ty, vx, vy = (read_idx(p) for p in found)
    tx = (tx.astype(np.float32) / 255.0)[..., None]
    vx = (vx.astype(np.float32) / 255.0)[..., None]
    return tx, ty.astype(np.int64), vx, vy.astype(np.int64)


def _try_load_cifar(cache_dir: str, name: str):
    """CIFAR-10/100 archives: the python pickle batches
    (``cifar-10-batches-py/``, ``cifar-100-python/``) or the binary rows
    (``cifar-10-batches-bin/``, ``cifar-100-binary/``)."""
    import pickle

    is100 = "100" in name
    py_dir = os.path.join(cache_dir, "cifar-100-python" if is100
                          else "cifar-10-batches-py")
    if os.path.isdir(py_dir):
        label_key = b"fine_labels" if is100 else b"labels"

        def read_batches(names):
            xs, ys = [], []
            for n in names:
                p = os.path.join(py_dir, n)
                if not os.path.exists(p):
                    continue
                with open(p, "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                xs.append(np.asarray(d[b"data"], np.uint8))
                ys.append(np.asarray(d[label_key], np.int64))
            if not xs:
                return None, None
            return np.concatenate(xs), np.concatenate(ys)

        train_names = ["train"] if is100 else [f"data_batch_{i}"
                                              for i in range(1, 6)]
        tx, ty = read_batches(train_names)
        vx, vy = read_batches(["test"] if is100 else ["test_batch"])
        if tx is None or vx is None:
            return None

        def to_img(flat):
            return (flat.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
                    .astype(np.float32) / 255.0)

        return to_img(tx), ty, to_img(vx), vy

    bin_dir = os.path.join(cache_dir, "cifar-100-binary" if is100
                           else "cifar-10-batches-bin")
    if os.path.isdir(bin_dir):
        label_bytes = 2 if is100 else 1
        row = label_bytes + 3072

        def read_bin(names):
            xs, ys = [], []
            for n in names:
                p = os.path.join(bin_dir, n)
                if not os.path.exists(p):
                    continue
                raw = np.fromfile(p, dtype=np.uint8)
                raw = raw[: (len(raw) // row) * row].reshape(-1, row)
                ys.append(raw[:, label_bytes - 1].astype(np.int64))
                xs.append(raw[:, label_bytes:])
            if not xs:
                return None, None
            x = np.concatenate(xs)
            x = (x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
                 .astype(np.float32) / 255.0)
            return x, np.concatenate(ys)

        train_names = ["train.bin"] if is100 else \
            [f"data_batch_{i}.bin" for i in range(1, 6)]
        tx, ty = read_bin(train_names)
        vx, vy = read_bin(["test.bin"] if is100 else ["test_batch.bin"])
        if tx is None or vx is None:
            return None
        return tx, ty, vx, vy
    return None


def _sizes(args, train_n: int, test_n: int,
           cap: Optional[Tuple[int, int]] = None) -> Tuple[int, int]:
    """Explicit ``args.train_size``/``test_size`` win over the defaults
    (capped by ``cap`` for reference-scale cardinalities)."""
    if cap is not None:
        train_n, test_n = min(train_n, cap[0]), min(test_n, cap[1])
    return (int(getattr(args, "train_size", 0) or train_n),
            int(getattr(args, "test_size", 0) or test_n))


def _clamped_cut(args, n: int) -> int:
    """Train/test split point of a fixed-size real pool: honour train_size
    but never let the test split go empty."""
    cut = int(getattr(args, "train_size", 0)) or int(n * 0.85)
    return min(cut, n - max(1, n // 10))


def _sklearn_tabular(name: str, seed: int):
    """sklearn's wine or breast-cancer table, rows permuted by the seed:
    (x, y, classes, source name); the class count is the whole table's."""
    from sklearn.datasets import load_breast_cancer, load_wine
    d = load_wine() if name == "wine" else load_breast_cancer()
    x = d.data.astype(np.float32)
    y = d.target.astype(np.int64)
    classes = int(y.max()) + 1
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    return x[perm], y[perm], classes, (
        "wine" if name == "wine" else "breast-cancer")


def load(args) -> Tuple[FederatedDataset, int]:
    name = str(getattr(args, "dataset", "synthetic_mnist")).lower()
    cache = str(getattr(args, "data_cache_dir", "") or "")
    seed = int(getattr(args, "random_seed", 0))
    client_num = int(getattr(args, "client_num_in_total", 10))
    method = str(getattr(args, "partition_method", "hetero"))
    alpha = float(getattr(args, "partition_alpha", 0.5))

    if name in _IMAGE_SPECS:
        classes, shape, train_n, test_n = _IMAGE_SPECS[name]
        if cache:
            # a LEAF layout keeps the natural per-user partition; it wins
            # over any partition_method re-split
            leaf_root = find_leaf_root(cache, name)
            if leaf_root is not None:
                tx, ty, vx, vy, cidx, tidx = load_leaf(leaf_root,
                                                       input_shape=shape)
                ds = FederatedDataset(
                    tx, ty, vx, vy, cidx, classes, test_client_idxs=tidx,
                    provenance=_cache_provenance(leaf_root, "real:leaf",
                                                 name))
                return ds, classes
        real = _try_load_npz(cache, name) if cache else None
        if real is None and name in ("mnist", "synthetic_mnist") and cache:
            real = _try_load_mnist_idx(cache)
        if real is None and name.startswith(("cifar", "fed_cifar")) and cache:
            real = _try_load_cifar(cache, name)
        if real is not None:
            tx, ty, vx, vy = real
            prov = _cache_provenance(cache, "real:cache", name)
        else:
            noise = float(getattr(args, "synthetic_noise", 0.35))
            train_n, test_n = _sizes(args, train_n, test_n)
            tx, ty, vx, vy = synthetic_image_classification(
                train_n, test_n, classes, shape, seed, noise)
            prov = "synthetic"
        ds = build_federated(tx, ty, vx, vy, classes, client_num, method,
                             alpha, seed, provenance=prov)
        return ds, classes

    if name in _LM_SPECS:
        vocab, seq_len, train_n, test_n = _LM_SPECS[name]
        seq_len = int(getattr(args, "seq_len", seq_len))
        if cache:
            leaf_root = find_leaf_root(cache, name)
            if leaf_root is not None:
                tx, ty, vx, vy, cidx, tidx = load_leaf(leaf_root,
                                                       seq_len=seq_len)
                ds = FederatedDataset(
                    tx, ty, vx, vy, cidx, vocab, test_client_idxs=tidx,
                    provenance=_cache_provenance(leaf_root, "real:leaf",
                                                 name))
                return ds, vocab
        real = _try_load_npz(cache, name) if cache else None
        if real is None and cache and "shakespeare" in name:
            # the raw corpus, where the LEAF layout would be too
            for cand in (os.path.join(cache, "shakespeare.txt"),
                         os.path.join(cache, name, "shakespeare.txt"),
                         os.path.join(cache, "shakespeare",
                                      "shakespeare.txt")):
                if os.path.exists(cand):
                    real = load_shakespeare_raw(cand, seq_len)
                    break
        if real is not None:
            tx, ty, vx, vy = real
            prov = _cache_provenance(cache, "real:cache", name)
        else:
            train_n, test_n = _sizes(args, train_n, test_n)
            tx, ty, vx, vy = synthetic_lm_tokens(train_n, test_n, vocab,
                                                 seq_len, seed)
            prov = "synthetic"
        ds = build_federated(tx, ty, vx, vy, vocab, client_num, method="homo",
                             alpha=alpha, seed=seed, provenance=prov)
        return ds, vocab

    if name in _TAGPRED_SPECS:
        ref_tags, ref_feats, ref_train_n, ref_test_n = _TAGPRED_SPECS[name]
        real = _try_load_npz(cache, name) if cache else None
        if real is not None:
            tx, ty, vx, vy = real
            for part, lab in (("train", ty), ("test", vy)):
                if lab.ndim != 2 or not np.isin(np.unique(lab), (0, 1)).all():
                    raise ValueError(
                        f"{name}.npz {part} labels must be multi-hot "
                        f"(N, n_tags) 0/1 matrices (tag-prediction task), "
                        f"got shape {lab.shape} dtype {lab.dtype} — old "
                        f"LM-format caches are invalid")
            if ty.shape[1] != vy.shape[1]:
                raise ValueError(
                    f"{name}.npz train/test tag counts differ: "
                    f"{ty.shape[1]} vs {vy.shape[1]}")
            ty, vy = ty.astype(np.float32), vy.astype(np.float32)
            n_tags, n_feats = ty.shape[1], tx.shape[1]
        else:
            # the reference-scale dense matrix would be 50k × 10k floats:
            # capped unless the overrides ask for more
            n_tags = int(getattr(args, "tag_count", 0) or min(ref_tags, 100))
            n_feats = int(getattr(args, "feature_dim", 0) or
                          min(ref_feats, 1000))
            train_n, test_n = _sizes(args, ref_train_n, ref_test_n,
                                     cap=(5000, 500))
            tx, ty, vx, vy = synthetic_tag_prediction(
                train_n, test_n, n_tags, n_feats, seed)
        # the partition's class: each row's first (lowest-index) tag
        primary = np.argmax(ty, axis=1).astype(np.int64)
        client_idxs = partition(primary, client_num, method, alpha, seed)
        ds = FederatedDataset(
            tx, ty, vx, vy, client_idxs, n_tags,
            provenance=_cache_provenance(cache, "real:npz", name)
            if real is not None else "synthetic")
        if not getattr(args, "input_shape", None):
            args.input_shape = (n_feats,)
        # the loader knows the task; the model hub reads it
        args.task_type = "tag_prediction"
        return ds, n_tags

    if name in _TABULAR_SPECS:
        classes, n_features, train_n, test_n = _TABULAR_SPECS[name]
        real = _try_load_npz(cache, name) if cache else None
        if real is not None:
            tx, ty, vx, vy = real
            prov = _cache_provenance(cache, "real:npz", name)
        else:
            train_n, test_n = _sizes(args, train_n, test_n)
            tx, ty, vx, vy = synthetic_tabular(train_n, test_n, classes,
                                               n_features, seed)
            prov = "synthetic"
        ds = build_federated(tx, ty, vx, vy, classes, client_num, method,
                             alpha, seed, provenance=prov)
        return ds, classes

    if name in _TEXTCLS_SPECS:
        (classes, vocab, seq_len, train_n, test_n, cls_signal,
         kw_width) = _TEXTCLS_SPECS[name]
        seq_len = int(getattr(args, "seq_len", seq_len))
        # model and data share one token space
        vocab = int(getattr(args, "vocab_size", 0) or vocab)
        train_n, test_n = _sizes(args, train_n, test_n)
        real = _try_load_npz(cache, name) if cache else None
        if real is not None:
            tx, ty, vx, vy = real
            prov = _cache_provenance(cache, "real:npz", name)
        else:
            tx, ty, vx, vy = synthetic_text_classification(
                train_n, test_n, classes, vocab, seq_len, seed,
                class_signal=float(getattr(args, "text_class_signal",
                                           cls_signal)),
                keyword_width=float(getattr(args, "text_keyword_width",
                                            kw_width)))
            prov = "synthetic"
        ds = build_federated(tx, ty, vx, vy, classes, client_num, method,
                             alpha, seed, provenance=prov)
        return ds, classes

    if name in _SEG_SPECS:
        classes, shape, train_n, test_n = _SEG_SPECS[name]
        train_n, test_n = _sizes(args, train_n, test_n)
        shape = tuple(getattr(args, "input_shape", None) or shape)
        real = _try_load_npz(cache, name) if cache else None
        if real is not None:
            tx, ty, vx, vy = real
        else:
            tx, ty, vx, vy = synthetic_segmentation(
                train_n, test_n, classes, shape, seed)
        # the Dirichlet partition needs one label a sample: each mask's
        # dominant class (the stand-in for FeTS's per-institution skew)
        dominant = np.array([np.bincount(m.reshape(-1),
                                         minlength=classes).argmax()
                             for m in ty])
        client_idxs = partition(dominant, client_num, method, alpha, seed)
        ds = FederatedDataset(
            tx, ty, vx, vy, client_idxs, classes,
            provenance=_cache_provenance(cache, "real:npz", name)
            if real is not None else "synthetic")
        return ds, classes

    if name in ("breast_cancer", "wine", "uci_real"):
        # real tabular bytes without a download: sklearn's breast-cancer
        # (569 × 30, 2 classes) and wine (178 × 13, 3 classes) tables
        x, y, classes, src = _sklearn_tabular(name, seed)
        cut = _clamped_cut(args, len(x))
        # standardised with the train split's statistics only
        mu, sd = x[:cut].mean(0), x[:cut].std(0)
        x = (x - mu) / (sd + 1e-8)
        tx, ty, vx, vy = x[:cut], y[:cut], x[cut:], y[cut:]
        ds = build_federated(tx, ty, vx, vy, classes, client_num, method,
                             alpha, seed, provenance=f"real:sklearn-{src}")
        return ds, classes

    if name == "digits":
        # real bytes without a download: the committed LEAF shard
        # (data_shards/digits) with its per-user partition (a round-robin
        # split; the corpus has no writer ids), else sklearn's digits set
        # re-split; never synthetic
        if cache:
            leaf_root = find_leaf_root(cache, "digits")
            if leaf_root is not None:
                tx, ty, vx, vy, cidx, tidx = load_leaf(
                    leaf_root, input_shape=(8, 8, 1))
                ds = FederatedDataset(
                    tx, ty, vx, vy, cidx, 10, test_client_idxs=tidx,
                    provenance=_cache_provenance(leaf_root, "real:leaf",
                                                 "digits"))
                return ds, 10
        from sklearn.datasets import load_digits
        d = load_digits()
        x = (d.data.astype(np.float32) / 16.0).reshape(-1, 8, 8, 1)
        y = d.target.astype(np.int64)
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(x))
        x, y = x[perm], y[perm]
        cut = _clamped_cut(args, len(x))
        tx, ty, vx, vy = x[:cut], y[:cut], x[cut:], y[cut:]
        ds = build_federated(tx, ty, vx, vy, 10, client_num, method, alpha,
                             seed, provenance="real:sklearn-digits")
        return ds, 10

    if name.startswith("synthetic"):
        # synthetic_<classes>_<dim...> generic generator
        classes = int(getattr(args, "num_classes", 10))
        shape = tuple(getattr(args, "input_shape", (28, 28, 1)))
        tx, ty, vx, vy = synthetic_image_classification(
            int(getattr(args, "train_size", 10000)),
            int(getattr(args, "test_size", 2000)), classes, shape, seed)
        ds = build_federated(tx, ty, vx, vy, classes, client_num, method,
                             alpha, seed, provenance="synthetic")
        return ds, classes

    if name in _UNPORTED:
        raise NotImplementedError(
            f"dataset {name!r} ({_UNPORTED[name]}) is not ported yet")
    raise ValueError(f"unknown dataset {name!r}")


def load_vertical(args):
    """Vertically partitioned load for vertical FL: ``(party feature
    arrays, labels, classes)``.  ``breast_cancer``/``wine``/``uci_real``
    split sklearn's table into contiguous column blocks (standardised over
    the returned rows); ``nus_wide`` gives party A NUS-WIDE's 634 image
    features and party B its 1,000 text tags (128 for each further party);
    any other name ``features_per_party`` (16) each, all from the
    synthetic generator."""
    name = str(getattr(args, "dataset", "nus_wide")).lower()
    parties = int(getattr(args, "vfl_parties", 2))
    seed = int(getattr(args, "random_seed", 0))
    n = int(getattr(args, "train_size", 4000))
    if name in ("breast_cancer", "wine", "uci_real"):
        # the class count is the whole table's (a small slice may miss one)
        x, labels, classes, _ = _sklearn_tabular(name, seed)
        x, labels = x[:n], labels[:n]
        x = (x - x.mean(0)) / (x.std(0) + 1e-8)
        splits = np.array_split(np.arange(x.shape[1]), parties)
        return [x[:, idx] for idx in splits], labels, classes
    if name in ("nus_wide", "nuswide"):
        fpp = [634, 1000][:parties] if parties <= 2 else [634, 1000] + \
            [128] * (parties - 2)
    else:
        fpp = int(getattr(args, "features_per_party", 16))
    classes = int(getattr(args, "num_classes", 2))
    feats, labels = synthetic_vertical_parties(n, parties, fpp, classes, seed)
    return feats, labels, classes
