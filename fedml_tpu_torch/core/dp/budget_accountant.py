"""RDP budget accountant (derived from the TF-Privacy moments accountant).

A pure ``math``/numpy copy of ``fedml_tpu.core.dp.budget_accountant``,
held to it bitwise by ``tests/test_torch_trust_attack_dp.py``.

Tracks Rényi-DP of the subsampled Gaussian mechanism across rounds and
converts to (ε, δ)-DP.  Compact numpy implementation of the standard
log-domain binomial-expansion bound for integer orders (Mironov et al.;
Wang/Balle/Kasiviswanathan for subsampling).
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np

DEFAULT_ORDERS = tuple([1.25, 1.5, 1.75, 2.0, 2.5] + list(range(3, 64)) +
                       [128.0, 256.0])


def _log_add(a: float, b: float) -> float:
    if a == -np.inf:
        return b
    if b == -np.inf:
        return a
    m = max(a, b)
    return m + math.log1p(math.exp(min(a, b) - m))


def _rdp_gaussian(sigma: float, alpha: float) -> float:
    return alpha / (2.0 * sigma ** 2)


def _rdp_subsampled_gaussian(q: float, sigma: float, alpha: float) -> float:
    """RDP at integer order alpha for the Poisson-subsampled Gaussian
    (binomial expansion in log domain); fractional orders use the integer
    bound at ceil(alpha) which is valid since RDP is monotone in alpha."""
    if q == 0:
        return 0.0
    if q == 1.0:
        return _rdp_gaussian(sigma, alpha)
    a = int(math.ceil(alpha))
    log_terms = []
    for k in range(a + 1):
        log_binom = (math.lgamma(a + 1) - math.lgamma(k + 1)
                     - math.lgamma(a - k + 1))
        log_t = (log_binom + k * math.log(q) + (a - k) * math.log1p(-q)
                 + (k * k - k) / (2.0 * sigma ** 2))
        log_terms.append(log_t)
    acc = -np.inf
    for t in log_terms:
        acc = _log_add(acc, t)
    return acc / (a - 1) if a > 1 else acc


class BudgetAccountant:
    """Accumulates per-round RDP and reports the (ε, δ) spent."""

    def __init__(self, orders: Sequence[float] = DEFAULT_ORDERS):
        self.orders = tuple(orders)
        self.rdp = np.zeros(len(self.orders))

    def compose_subsampled_gaussian(self, q: float, sigma: float,
                                    steps: int = 1):
        self.rdp += np.array([
            _rdp_subsampled_gaussian(q, sigma, a) for a in self.orders
        ]) * steps
        return self

    def get_privacy_spent(self, delta: float = 1e-5):
        """ε = min over orders of rdp − log(δ)/(α−1) (RDP→DP conversion)."""
        eps = np.array([
            r - math.log(delta) / (a - 1) if a > 1 else np.inf
            for r, a in zip(self.rdp, self.orders)
        ])
        i = int(np.argmin(eps))
        return float(eps[i]), self.orders[i]


def compute_rdp(q: float, noise_multiplier: float, steps: int,
                orders: Iterable[float]):
    """TF-Privacy-compatible helper (reference rdp_accountant.compute_rdp)."""
    return np.array([
        _rdp_subsampled_gaussian(q, noise_multiplier, a) for a in orders
    ]) * steps


def get_privacy_spent(orders, rdp, target_delta: float = 1e-5):
    acc = BudgetAccountant(orders)
    acc.rdp = np.asarray(rdp, dtype=float)
    eps, order = acc.get_privacy_spent(target_delta)
    return eps, order
