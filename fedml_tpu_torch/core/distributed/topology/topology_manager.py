"""Topology managers for decentralized FL (copy of
``fedml_tpu.core.distributed.topology.topology_manager``, numpy only;
reference ``core/distributed/topology/symmetric_topology_manager.py:7`` /
``asymmetric_topology_manager.py:7``).

Generates the per-node neighbor weight matrix used by decentralized
averaging (DSGD / push-sum): a (n, n) mixing matrix contracted against the
stacked client models — one matmul instead of per-edge messages.
"""

from __future__ import annotations

import numpy as np


class BaseTopologyManager:
    def __init__(self, n: int):
        self.n = int(n)
        self.topology: np.ndarray = np.zeros((n, n), dtype=np.float32)

    def get_in_neighbor_idx_list(self, node_index: int):
        return [j for j in range(self.n)
                if self.topology[j][node_index] > 0 and j != node_index]

    def get_out_neighbor_idx_list(self, node_index: int):
        return [j for j in range(self.n)
                if self.topology[node_index][j] > 0 and j != node_index]

    def get_in_neighbor_weights(self, node_index: int):
        return list(self.topology[:, node_index])

    def get_out_neighbor_weights(self, node_index: int):
        return list(self.topology[node_index])

    def mixing_matrix(self) -> np.ndarray:
        return self.topology


class SymmetricTopologyManager(BaseTopologyManager):
    """Ring with `neighbor_num` symmetric neighbors, rows doubly stochastic
    (reference symmetric_topology_manager.py — networkx ring lattice +
    symmetrization, rebuilt without the networkx dependency)."""

    def __init__(self, n: int, neighbor_num: int = 2):
        super().__init__(n)
        self.neighbor_num = min(neighbor_num, n - 1)
        self.generate_topology()

    def generate_topology(self):
        n, k = self.n, self.neighbor_num
        adj = np.eye(n, dtype=np.float32)
        for i in range(n):
            for d in range(1, k // 2 + 1):
                adj[i][(i + d) % n] = 1.0
                adj[i][(i - d) % n] = 1.0
            if k % 2 == 1:
                adj[i][(i + k // 2 + 1) % n] = 1.0
        adj = np.maximum(adj, adj.T)  # symmetrize
        self.topology = adj / adj.sum(axis=1, keepdims=True)


class AsymmetricTopologyManager(BaseTopologyManager):
    """Directed ring-lattice with row-stochastic weights (reference
    asymmetric_topology_manager.py)."""

    def __init__(self, n: int, neighbor_num: int = 2):
        super().__init__(n)
        self.neighbor_num = min(neighbor_num, n - 1)
        self.generate_topology()

    def generate_topology(self):
        n, k = self.n, self.neighbor_num
        adj = np.eye(n, dtype=np.float32)
        for i in range(n):
            for d in range(1, k + 1):
                adj[i][(i + d) % n] = 1.0
        self.topology = adj / adj.sum(axis=1, keepdims=True)
