"""Byzantine attack (port of
``fedml_tpu.core.security.attack.byzantine_attack``): the first
``byzantine_client_num`` clients submit corrupted updates — ``zero``,
``random`` (Gaussian at each leaf's own scale) or ``flip`` (negated).

The random mode's noise comes from the ``byzantine`` generator on the
update's device (:mod:`fedml_tpu_torch.core.noise`), one draw per leaf in
the JAX leaf order, as the JAX attack splits one key per leaf.
"""

from __future__ import annotations

import torch

from ... import noise
from ...tree import tree_scale, tree_zeros_like
from ..defense.common import leaf_noise


class ByzantineAttack:
    def __init__(self, args):
        self.byzantine_client_num = int(getattr(args, "byzantine_client_num",
                                                1))
        self.attack_mode = str(getattr(args, "attack_mode",
                                       "random")).lower()
        self._noise = noise.NoiseSource(
            "byzantine", int(getattr(args, "random_seed", 0)))

    def _corrupt(self, params):
        if self.attack_mode == "zero":
            return tree_zeros_like(params)
        if self.attack_mode == "flip":
            return tree_scale(params, -1.0)
        # random: Gaussian with each leaf's own scale
        z = leaf_noise(self._noise, params, dtypes=True)
        return {k: z[k] * (torch.std(v.to(torch.float32), correction=0)
                           + 1e-3)
                for k, v in params.items()}

    def attack_model(self, model_params, sample_num):
        return self._corrupt(model_params)

    def attack_model_list(self, model_list):
        """Server-side injection: the first f clients turn byzantine."""
        out = list(model_list)
        for i in range(min(self.byzantine_client_num, len(out))):
            n, p = out[i]
            out[i] = (n, self._corrupt(p))
        return out
