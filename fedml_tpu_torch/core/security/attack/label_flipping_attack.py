"""Label-flipping data poisoning: poisoned clients map
``original_class_list[i] → target_class_list[i]`` in their training labels.

A numpy copy of ``fedml_tpu.core.security.attack.label_flipping_attack``,
held to it bitwise on the same inputs by
``tests/test_torch_trust_attack_dp.py``."""

from __future__ import annotations

import numpy as np


class LabelFlippingAttack:
    def __init__(self, args):
        self.original = list(getattr(args, "original_class_list", [1]))
        self.target = list(getattr(args, "target_class_list", [7]))
        self.poison_ratio = float(getattr(args, "poisoned_client_ratio", 0.5))

    def active_this_round(self) -> bool:
        return True

    def poison_data(self, dataset):
        """dataset: (x, y) arrays or a FederatedDataset-like; returns same
        structure with flipped labels."""
        if isinstance(dataset, tuple) and len(dataset) == 2:
            x, y = dataset
            return x, self._flip(np.array(y))
        if hasattr(dataset, "train_y"):
            dataset.train_y = self._flip(np.array(dataset.train_y))
            return dataset
        return dataset

    def _flip(self, y):
        out = y.copy()
        for o, t in zip(self.original, self.target):
            out[y == o] = t
        return out
