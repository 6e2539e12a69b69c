"""Backdoor data-poisoning attacks: a pixel-pattern trigger with a target
label, and the edge-case variant (poison with rare edge-case examples).
The trigger is a corner patch stamped into a fraction of the poisoned
client's samples, all relabeled to ``backdoor_target_label``.

A numpy copy of ``fedml_tpu.core.security.attack.backdoor_attack``, held
to it bitwise on the same inputs by ``tests/test_torch_trust_attack_dp.py``.
"""

from __future__ import annotations

import numpy as np


class BackdoorAttack:
    def __init__(self, args):
        self.target_label = int(getattr(args, "backdoor_target_label", 0))
        self.trigger_frac = float(getattr(args, "backdoor_trigger_frac", 0.3))
        self.patch = int(getattr(args, "backdoor_patch_size", 3))

    def active_this_round(self) -> bool:
        return True

    def _stamp(self, x):
        x = np.array(x, copy=True)
        p = self.patch
        if x.ndim >= 3:           # (..., H, W, C) image batch
            x[..., :p, :p, :] = 1.0
        return x

    def poison_data(self, dataset):
        if isinstance(dataset, tuple) and len(dataset) == 2:
            x, y = np.array(dataset[0], copy=True), np.array(dataset[1], copy=True)
            n = len(x)
            k = int(self.trigger_frac * n)
            idx = np.arange(n)[:k]
            x[idx] = self._stamp(x[idx])
            y[idx] = self.target_label
            return x, y
        return dataset


class EdgeCaseBackdoorAttack(BackdoorAttack):
    """Edge-case variant (reference edge_case_attack.py): instead of a pixel
    trigger, inject out-of-distribution samples labeled with the target.

    When an edge-example pool is available — the ``edge_case_examples``
    dataset carries one as ``edge_x``/``edge_y`` (the reference ships
    ARDIS/Southwest pools in ``data/edge_case_examples/``) — poisoned
    samples are drawn from it; otherwise edge cases are synthesized as
    intensity-inverted versions of the client's own samples (off-manifold
    for normalized image data, no egress needed)."""

    def __init__(self, args):
        super().__init__(args)
        self.edge_pool = None  # (x, y) arrays; set via set_edge_pool

    def set_edge_pool(self, edge_x, edge_y=None):
        self.edge_pool = (np.asarray(edge_x),
                          None if edge_y is None else np.asarray(edge_y))

    def poison_data(self, dataset):
        if isinstance(dataset, tuple) and len(dataset) == 2:
            x, y = (np.array(dataset[0], copy=True),
                    np.array(dataset[1], copy=True))
            n = len(x)
            k = max(int(self.trigger_frac * n), 1)
            if self.edge_pool is not None:
                ex, ey = self.edge_pool
                take = np.resize(np.arange(len(ex)), k)
                x[:k] = ex[take]
                y[:k] = (self.target_label if ey is None
                         else ey[take])
            else:
                x[:k] = 1.0 - x[:k]  # inverted = off-manifold for digits
                y[:k] = self.target_label
            return x, y
        return dataset
