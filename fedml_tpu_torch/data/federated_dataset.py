"""FederatedDataset — numpy copy of ``fedml_tpu.data.federated_dataset``.

All data lives as two dense host arrays (x, y) plus per-client index
arrays; batches are materialized by gather.  Every schedule here is bitwise
the JAX package's (same Philox streams), so a cohort, its batch order and
its step mask are identical in both packages for a given seed and round.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..core import hostrng
from ..core.data.noniid_partition import partition, record_data_stats


@dataclasses.dataclass
class FederatedDataset:
    train_x: np.ndarray          # (N, ...) model-ready features
    train_y: np.ndarray          # (N,) int labels (or (N, seq) token targets)
    test_x: np.ndarray
    test_y: np.ndarray
    client_idxs: Dict[int, np.ndarray]   # client -> train indices
    num_classes: int
    test_client_idxs: Optional[Dict[int, np.ndarray]] = None
    #: "synthetic" or "real:<source>" — stamped by the loader
    provenance: str = "unknown"

    @property
    def num_clients(self) -> int:
        return len(self.client_idxs)

    @property
    def train_data_num(self) -> int:
        return len(self.train_x)

    @property
    def test_data_num(self) -> int:
        return len(self.test_x)

    def client_sample_counts(self) -> np.ndarray:
        return np.array([len(self.client_idxs[c])
                         for c in range(self.num_clients)], dtype=np.int64)

    def stats(self):
        return record_data_stats(self.train_y, self.client_idxs,
                                 self.num_classes)

    # -- batching ----------------------------------------------------------
    def client_batches(self, client: int, batch_size: int, seed: int,
                       round_idx: int, epochs: int = 1
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(epochs*steps, batch, ...) feature and label arrays for one
        client, one fresh permutation per epoch."""
        idx = self.client_index_batches(client, batch_size, seed, round_idx,
                                        epochs)
        total = idx.shape[0]
        flat = idx.reshape(-1)
        xb = self.train_x[flat].reshape(
            (total, batch_size) + self.train_x.shape[1:])
        yb = self.train_y[flat].reshape(
            (total, batch_size) + self.train_y.shape[1:])
        return xb, yb

    def client_index_batches(self, client: int, batch_size: int, seed: int,
                             round_idx: int, epochs: int = 1) -> np.ndarray:
        """(steps, batch) index array from the per-(client, epoch) stream;
        short clients are padded by repetition up to one full batch."""
        base = self.client_idxs[client]
        all_idx = []
        for e in range(epochs):
            rng = hostrng.gen(seed, round_idx * 1031 + e, client, 1)
            idx = rng.permutation(base)
            if len(idx) < batch_size:
                reps = int(np.ceil(batch_size / max(len(idx), 1)))
                idx = np.tile(idx, reps)[:batch_size]
            steps = len(idx) // batch_size
            all_idx.append(idx[: steps * batch_size])
        idx = np.concatenate(all_idx)
        total = len(idx) // batch_size
        return idx[: total * batch_size].reshape(total, batch_size)

    def cohort_indices(self, clients, batch_size: int, seed: int,
                       round_idx: int, epochs: int = 1,
                       max_steps: Optional[int] = None):
        """Padded cohort INDEX tensor ``(n_clients, steps, batch)`` int32,
        step mask and weights: what the device-gather round ships instead
        of the data (padding indices point at row 0, masked out)."""
        per = [self.client_index_batches(c, batch_size, seed, round_idx,
                                         epochs) for c in clients]
        steps = max(p.shape[0] for p in per)
        if max_steps is not None:
            steps = min(steps, max_steps)
        n = len(clients)
        idx = np.zeros((n, steps, batch_size), dtype=np.int32)
        mask = np.zeros((n, steps), dtype=np.float32)
        for i, p in enumerate(per):
            s = min(p.shape[0], steps)
            idx[i, :s], mask[i, :s] = p[:s], 1.0
        w = np.array([len(self.client_idxs[c]) for c in clients],
                     dtype=np.float32)
        return idx, mask, w

    def cohort_batches(self, clients, batch_size: int, seed: int, round_idx: int,
                       epochs: int = 1, max_steps: Optional[int] = None):
        """Padded cohort tensor ``(x, y, step_mask, weights)``: x is
        ``(n_clients, steps, batch, ...)``; ``step_mask[c, s]`` is 0 where
        client c ran out of data; ``weights`` are per-client sample counts."""
        per = [self.client_batches(c, batch_size, seed, round_idx, epochs)
               for c in clients]
        steps = max(x.shape[0] for x, _ in per)
        if max_steps is not None:
            steps = min(steps, max_steps)
        n = len(clients)
        x = np.zeros((n, steps) + per[0][0].shape[1:], dtype=self.train_x.dtype)
        y = np.zeros((n, steps) + per[0][1].shape[1:], dtype=self.train_y.dtype)
        mask = np.zeros((n, steps), dtype=np.float32)
        for i, (xb, yb) in enumerate(per):
            s = min(xb.shape[0], steps)
            x[i, :s], y[i, :s], mask[i, :s] = xb[:s], yb[:s], 1.0
        w = np.array([len(self.client_idxs[c]) for c in clients], dtype=np.float32)
        return x, y, mask, w

    def test_batches(self, batch_size: int = 256):
        """Full test set batched, ragged tail zero-padded; returns
        (xb, yb, valid_mask) with mask shape (steps, batch)."""
        n = len(self.test_x)
        steps = -(-n // batch_size)
        pad = steps * batch_size - n
        xp = np.concatenate([self.test_x,
                             np.zeros((pad,) + self.test_x.shape[1:],
                                      self.test_x.dtype)])
        yp = np.concatenate([self.test_y,
                             np.zeros((pad,) + self.test_y.shape[1:],
                                      self.test_y.dtype)])
        m = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
        xb = xp.reshape((steps, batch_size) + self.test_x.shape[1:])
        yb = yp.reshape((steps, batch_size) + self.test_y.shape[1:])
        return xb, yb, m.reshape(steps, batch_size)

    def pack_per_client(self, batch_size: int, split: str = "train"):
        """Every client's local split padded to one ``(C, steps, B, ...)``
        stack with validity masks; clients with no data are excluded."""
        if split == "test" and self.test_client_idxs:
            idxs, data_x, data_y = (self.test_client_idxs, self.test_x,
                                    self.test_y)
        else:
            idxs, data_x, data_y = (self.client_idxs, self.train_x,
                                    self.train_y)
        clients = sorted(c for c in idxs if len(idxs[c]) > 0)
        if not clients:
            raise ValueError(f"no client has data in the {split!r} split")
        counts = [len(idxs[c]) for c in clients]
        steps = max(1, -(-max(counts) // batch_size))
        slot = steps * batch_size
        C = len(clients)
        X = np.zeros((C, slot) + data_x.shape[1:], data_x.dtype)
        Y = np.zeros((C, slot) + data_y.shape[1:], data_y.dtype)
        M = np.zeros((C, slot), np.float32)
        for i, c in enumerate(clients):
            rows = idxs[c]
            X[i, : len(rows)] = data_x[rows]
            Y[i, : len(rows)] = data_y[rows]
            M[i, : len(rows)] = 1.0
        shape = (C, steps, batch_size)
        return (np.asarray(clients), X.reshape(shape + data_x.shape[1:]),
                Y.reshape(shape + data_y.shape[1:]), M.reshape(shape))


def build_federated(train_x, train_y, test_x, test_y, num_classes: int,
                    client_num: int, method: str, alpha: float, seed: int,
                    provenance: str = "unknown") -> FederatedDataset:
    client_idxs = partition(train_y, client_num, method, alpha, seed)
    return FederatedDataset(train_x, train_y, test_x, test_y, client_idxs,
                            num_classes, provenance=provenance)
