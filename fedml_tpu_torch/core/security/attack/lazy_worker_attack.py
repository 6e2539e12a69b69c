"""Lazy worker (free-rider) attack (port of
``fedml_tpu.core.security.attack.lazy_worker_attack``): the client skips
training and echoes a perturbed copy of a previous global model.  The
perturbation comes from the ``lazy_worker`` generator
(:mod:`fedml_tpu_torch.core.noise`), one draw per leaf in the JAX leaf
order."""

from __future__ import annotations

from ... import noise
from ..defense.common import leaf_noise


class LazyWorkerAttack:
    def __init__(self, args):
        self.noise_scale = float(getattr(args, "lazy_noise_scale", 1e-3))
        self._noise = noise.NoiseSource(
            "lazy_worker", int(getattr(args, "random_seed", 0)))
        self._last_global = None

    def set_global_model(self, params):
        self._last_global = params

    def _noisy_echo(self, params):
        z = leaf_noise(self._noise, params, dtypes=True)
        return {k: v + self.noise_scale * z[k] for k, v in params.items()}

    def attack_model(self, model_params, sample_num):
        base = self._last_global if self._last_global is not None \
            else model_params
        return self._noisy_echo(base)

    def attack_model_list(self, model_list):
        out = list(model_list)
        if out:
            n, p = out[0]
            out[0] = (n, self.attack_model(p, n))
        return out
