"""LEAF-format federated dataset ingestion (numpy copy of
``fedml_tpu.data.leaf``).

A LEAF split directory holds json shards with keys ``users``,
``num_samples`` and ``user_data`` = {user: {"x": [...], "y": [...]}};
:func:`load_leaf` merges both splits into dense arrays plus per-client index
maps, keeping the NATURAL per-user partition.  Character rows are encoded
with the LEAF letter table.  :func:`load_shakespeare_raw` cuts the raw
Shakespeare corpus into next-character windows.  Bitwise the JAX package's
arrays for the same files.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

ALL_LETTERS = (
    "\n !\"&'(),-.0123456789:;>?ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "[]abcdefghijklmnopqrstuvwxyz}"
)
_CHAR_TO_ID = {c: i + 1 for i, c in enumerate(ALL_LETTERS)}  # 0 = unk/pad


def encode_chars(text: str, seq_len: Optional[int] = None) -> List[int]:
    ids = [_CHAR_TO_ID.get(c, 0) for c in text]
    if seq_len is not None:
        ids = (ids + [0] * seq_len)[:seq_len]
    return ids


def read_leaf_dir(split_dir: str) -> Tuple[List[str], Dict[str, dict]]:
    """Merge every ``*.json`` in ``split_dir`` → (users, user_data)."""
    users: List[str] = []
    user_data: Dict[str, dict] = {}
    files = sorted(f for f in os.listdir(split_dir) if f.endswith(".json"))
    if not files:
        raise FileNotFoundError(f"no LEAF json files under {split_dir}")
    for fname in files:
        with open(os.path.join(split_dir, fname)) as f:
            blob = json.load(f)
        users.extend(blob["users"])
        user_data.update(blob["user_data"])
    return users, user_data


def _to_arrays(users, user_data, input_shape, seq_len):
    xs, ys, client_idxs = [], [], {}
    cursor = 0
    for ci, u in enumerate(users):
        ux, uy = user_data[u]["x"], user_data[u]["y"]
        enc_x = [encode_chars(row, seq_len) if isinstance(row, str) else row
                 for row in ux]
        n = len(enc_x)
        xs.extend(enc_x)
        ys.extend([encode_chars(r, seq_len)[0] if isinstance(r, str) else r
                   for r in uy])
        client_idxs[ci] = np.arange(cursor, cursor + n, dtype=np.int64)
        cursor += n
    x = np.asarray(xs)
    if x.dtype == object:
        raise ValueError("ragged LEAF x rows; provide fixed-length samples "
                         "or a seq_len to pad/truncate to")
    if input_shape is not None and x.ndim == 2 \
            and int(np.prod(input_shape)) == x.shape[1]:
        x = x.reshape((-1,) + tuple(input_shape))
    y = np.asarray(ys)
    if np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float32)
    if np.issubdtype(y.dtype, np.integer) or y.dtype == np.bool_:
        y = y.astype(np.int64)
    return x, y, client_idxs


def load_leaf(root: str, input_shape=None, seq_len: Optional[int] = None):
    """Load the LEAF dataset under ``root`` (``train/`` and ``test/`` split
    dirs of json shards).  Returns ``(train_x, train_y, test_x, test_y,
    client_idxs, test_client_idxs)``; test clients are keyed by the TRAIN
    user order, and a user absent from one split has an empty list there."""
    tr_users, tr_data = read_leaf_dir(os.path.join(root, "train"))
    te_users, te_data = read_leaf_dir(os.path.join(root, "test"))
    tx, ty, tr_idxs = _to_arrays(tr_users, tr_data, input_shape, seq_len)
    order = {u: i for i, u in enumerate(tr_users)}
    vx_list, vy_list, te_idxs = [], [], {i: [] for i in range(len(tr_users))}
    cursor = 0
    for u in te_users:
        enc = [encode_chars(r, seq_len) if isinstance(r, str) else r
               for r in te_data[u]["x"]]
        uy = [encode_chars(r, seq_len)[0] if isinstance(r, str) else r
              for r in te_data[u]["y"]]
        vx_list.extend(enc)
        vy_list.extend(uy)
        ci = order.get(u)
        if ci is not None:
            te_idxs[ci] = list(range(cursor, cursor + len(enc)))
        cursor += len(enc)
    vx = np.asarray(vx_list)
    if input_shape is not None and vx.ndim == 2 \
            and int(np.prod(input_shape)) == vx.shape[1]:
        vx = vx.reshape((-1,) + tuple(input_shape))
    vy = np.asarray(vy_list)
    if np.issubdtype(vx.dtype, np.floating):
        vx = vx.astype(np.float32)
    if np.issubdtype(vy.dtype, np.integer):
        vy = vy.astype(np.int64)
    te_idxs = {c: np.asarray(v, dtype=np.int64) for c, v in te_idxs.items()}
    return tx, ty, vx, vy, tr_idxs, te_idxs


def find_leaf_root(cache_dir: str, name: str) -> Optional[str]:
    """The LEAF layout for dataset ``name`` under the cache dir:
    ``<cache>/<name>/{train,test}`` or ``<cache>/{train,test}``."""
    for root in (os.path.join(cache_dir, name), cache_dir):
        if (os.path.isdir(os.path.join(root, "train"))
                and os.path.isdir(os.path.join(root, "test"))):
            train = os.path.join(root, "train")
            if any(f.endswith(".json") for f in os.listdir(train)):
                return root
    return None


def load_shakespeare_raw(path: str, seq_len: int, max_windows: int = 60000,
                         test_frac: float = 0.1, stride: int = None):
    """The raw Shakespeare corpus → char-LM windows: encode the whole text
    with the LEAF alphabet, cut it into ``seq_len + 1`` windows every
    ``stride`` (default ``seq_len``) characters, and split train/test by
    position.  Returns ``(train_x, train_y, test_x, test_y)``, x = chars
    [:-1] and y = chars[1:] of each window."""
    with open(path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    ids = np.asarray(encode_chars(text), np.int64)
    stride = int(stride or seq_len)
    if len(ids) < 2 * (seq_len + 1):
        raise ValueError(
            f"{path}: corpus too short for a train AND a test "
            f"{seq_len + 1}-char window ({len(ids)} chars)")
    n_win = min(max(2, (len(ids) - seq_len - 1) // stride), max_windows)
    windows = np.lib.stride_tricks.sliding_window_view(
        ids, seq_len + 1)[::stride][:n_win]
    n_win = len(windows)
    x, y = windows[:, :-1], windows[:, 1:]
    n_test = min(max(1, int(n_win * test_frac)), n_win - 1)
    # owned, contiguous arrays (a sliding view is read-only)
    return (np.ascontiguousarray(x[:-n_test]),
            np.ascontiguousarray(y[:-n_test]),
            np.ascontiguousarray(x[-n_test:]),
            np.ascontiguousarray(y[-n_test:]))
