"""Graph convolutional network for federated graph classification (port
of ``fedml_tpu.models.gcn``, the FedGraphNN family).

Graphs are padded to a fixed node count and fed as a dense normalised
adjacency Â = D^{-1/2}(A + I)D^{-1/2} and node features, so a GCN layer is
two batched products, Â·(X·W + b); after ``n_layers`` GCN + ReLU layers the
live nodes are mean-pooled into the ``readout`` Dense.  ``GCNPacked`` takes
one ``(B, N, N + F + 1)`` tensor ``[Â | X | node mask]`` per graph
(:func:`pack_graph_batch`), so the model rides the single-tensor trainer
and dataset.  The numpy helpers are copies of the JAX package's, bitwise.
Names are flax's (``gcn.gcn_0.Dense_0.weight`` ↔ ``gcn/gcn_0/Dense_0/
kernel``, ``gcn.readout.weight`` ↔ ``gcn/readout/kernel``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def normalize_adjacency(adj: np.ndarray, node_mask: np.ndarray) -> np.ndarray:
    """Â = D^{-1/2} (A + I) D^{-1/2}, masked to live nodes.  adj:
    (..., N, N) 0/1, node_mask: (..., N)."""
    eye = np.eye(adj.shape[-1], dtype=np.float32)
    a = (adj + eye) * node_mask[..., None, :] * node_mask[..., :, None]
    deg = a.sum(-1)
    dinv = np.where(deg > 0, deg ** -0.5, 0.0)
    return a * dinv[..., None, :] * dinv[..., :, None]


def pack_graph_batch(x, adj_norm, mask):
    """Pack (B,N,F), (B,N,N), (B,N) into the (B,N,N+F+1) GCNPacked input."""
    return np.concatenate(
        [adj_norm, x, mask[..., None]], axis=-1).astype(np.float32)


def synthetic_graph_classification(n_graphs: int, n_nodes: int,
                                   n_feats: int, classes: int,
                                   seed: int = 0):
    """Class-separable synthetic graphs: each class has a distinct edge
    density and feature mean (the MoleculeNet stand-in)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n_graphs)
    dens = 0.15 + 0.5 * (y / max(classes - 1, 1))
    sizes = rng.integers(max(3, n_nodes // 2), n_nodes + 1, n_graphs)
    x = np.zeros((n_graphs, n_nodes, n_feats), np.float32)
    adj = np.zeros((n_graphs, n_nodes, n_nodes), np.float32)
    mask = np.zeros((n_graphs, n_nodes), np.float32)
    for g in range(n_graphs):
        m = sizes[g]
        mask[g, :m] = 1.0
        x[g, :m] = rng.normal(0.5 * y[g], 1.0, (m, n_feats))
        upper = rng.random((m, m)) < dens[g]
        a = np.triu(upper, 1)
        adj[g, :m, :m] = a + a.T
    adj_norm = normalize_adjacency(adj, mask)
    return x, adj_norm, mask, y.astype(np.int64)


class GCNLayer(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)

    def forward(self, x: torch.Tensor, adj_norm: torch.Tensor
                ) -> torch.Tensor:
        return adj_norm @ self.Dense_0(x)


class GCNGraphClassifier(nn.Module):
    """(node feats (B,N,F), Â (B,N,N), node mask (B,N)) → (B, C)."""

    def __init__(self, num_classes: int, in_features: int, hidden: int = 64,
                 n_layers: int = 2):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            setattr(self, f"gcn_{i}", GCNLayer(
                in_features if i == 0 else hidden, hidden))
        self.readout = nn.Linear(hidden, num_classes)

    def forward(self, inputs, dropout_masks=None) -> torch.Tensor:
        x, adj_norm, node_mask = inputs
        for i in range(self.n_layers):
            x = F.relu(getattr(self, f"gcn_{i}")(x, adj_norm))
        x = x * node_mask[..., None]
        denom = torch.clamp(node_mask.sum(-1, keepdim=True), min=1.0)
        return self.readout(x.sum(-2) / denom)


class GCNPacked(nn.Module):
    """The model hub's GCN: one packed ``(B, N, N + F + 1)`` input."""

    def __init__(self, num_classes: int, n_nodes: int, n_feats: int,
                 hidden: int = 64, n_layers: int = 2):
        super().__init__()
        self.n_nodes = n_nodes
        self.gcn = GCNGraphClassifier(num_classes, n_feats, hidden, n_layers)

    def forward(self, packed: torch.Tensor, dropout_masks=None
                ) -> torch.Tensor:
        n = self.n_nodes
        return self.gcn((packed[..., n:-1], packed[..., :n],
                         packed[..., -1]))
