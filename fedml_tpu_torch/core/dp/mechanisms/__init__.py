"""DP noise mechanisms (port of ``fedml_tpu.core.dp.mechanisms``):
Gaussian and Laplace, dispatched by ``dp_mechanism_type``.  Each adds
noise to a params dict on its device, one
:func:`~fedml_tpu_torch.core.noise.draw` per leaf in the JAX leaf order
(the JAX mechanisms split one key per leaf)."""

from __future__ import annotations

import torch

from ...security.defense.common import leaf_noise


class Gaussian:
    """σ = sensitivity·√(2·ln(1.25/δ))/ε (the analytic Gaussian bound),
    in f32 as the JAX mechanism computes it."""

    def __init__(self, epsilon: float, delta: float = 1e-5,
                 sensitivity: float = 1.0):
        self.epsilon = float(epsilon)
        self.delta = float(delta)
        self.sensitivity = float(sensitivity)
        log = torch.log(torch.tensor(1.25 / self.delta, dtype=torch.float32))
        self.sigma = float(self.sensitivity * (2.0 * log) ** 0.5
                           / self.epsilon)

    def add_noise(self, tree, source):
        z = leaf_noise(source, tree)
        return {k: v + (self.sigma * z[k]).to(v.dtype)
                for k, v in tree.items()}


class Laplace:
    def __init__(self, epsilon: float, delta: float = 0.0,
                 sensitivity: float = 1.0):
        self.epsilon = float(epsilon)
        self.scale = float(sensitivity) / self.epsilon

    def add_noise(self, tree, source):
        z = leaf_noise(source, tree, kind="laplace")
        return {k: v + (self.scale * z[k]).to(v.dtype)
                for k, v in tree.items()}


def create_mechanism(args):
    mech = str(getattr(args, "dp_mechanism_type", "gaussian")).lower()
    eps = float(getattr(args, "dp_epsilon", getattr(args, "epsilon", 1.0)))
    delta = float(getattr(args, "dp_delta", getattr(args, "delta", 1e-5)))
    sens = float(getattr(args, "dp_sensitivity", 1.0))
    if mech == "laplace":
        return Laplace(eps, delta, sens)
    return Gaussian(eps, delta, sens)
