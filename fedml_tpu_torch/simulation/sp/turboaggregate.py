"""TurboAggregate (copy of ``fedml_tpu.simulation.sp.turboaggregate``):
multi-group circular secure aggregation.  Clients sit in L groups on a
ring; each group adds its masked updates to the running partial sum and
forwards it, and the additive masks cancel telescopically, so the server
only ever sees group-level partial sums.

A host-side field-arithmetic protocol over flat update vectors, bitwise the
JAX package's: it runs no device code."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ...core.hostrng import gen as hostgen
from ...core.mpc.secagg import P, dequantize, quantize


def ring_groups(n_clients: int, n_groups: int) -> List[List[int]]:
    """Round-robin assignment of clients to L ring groups."""
    groups: List[List[int]] = [[] for _ in range(n_groups)]
    for c in range(n_clients):
        groups[c % n_groups].append(c)
    return [g for g in groups if g]


class TurboAggregateAPI:
    """Aggregate ``updates`` (one flat float vector per client, pre-scaled
    by its weight) through the ring protocol; ``aggregate`` returns the
    exact weighted sum, and ``observed_partials`` holds the masked partial
    sums the server saw."""

    def __init__(self, n_clients: int, n_groups: int = 3, seed: int = 0):
        self.groups = ring_groups(n_clients, n_groups)
        self.seed = seed

    def aggregate(self, updates: Sequence[np.ndarray]) -> np.ndarray:
        d = len(updates[0])
        q = [quantize(np.asarray(u, np.float64)) for u in updates]
        # client c of group l adds mask m_c when its group takes the partial
        # sum; its shadow in group l+1 subtracts the same mask, so the masks
        # telescope to zero when the ring closes at the server
        partial = np.zeros(d, dtype=np.int64)
        carry_masks = np.zeros(d, dtype=np.int64)
        observed = []
        for group in self.groups:
            partial = (partial - carry_masks) % P
            carry_masks = np.zeros(d, dtype=np.int64)
            for c in group:
                m = hostgen(self.seed, 0x7A6B, c).integers(
                    0, P, size=d, dtype=np.int64)
                partial = (partial + q[c] + m) % P
                carry_masks = (carry_masks + m) % P
            observed.append(partial.copy())
        # the ring closes: the last group's masks go to the server
        total = (partial - carry_masks) % P
        self.observed_partials = observed
        return dequantize(total)
