"""Traffic-shape generators (copy of ``fedml_tpu.core.traffic``): open-loop
arrivals, a few hot entities with a long cold tail, and heavy-tailed sizes
and latencies, as pure numpy over caller-supplied ``np.random.Generator``
streams (``core/hostrng.py`` gives the deterministic per-purpose streams).
The event-driven client-arrival simulator (``simulation/async_sim.py``)
draws from them.  Each function consumes its generator exactly as the JAX
package's does, so the draws are bitwise its draws.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def zipf_weights(n: int, a: float = 1.2) -> np.ndarray:
    """Zipf popularity over n choices: rank r gets mass ∝ 1/r^a — a few
    hot entities (adapters, client cohorts) and a long cold tail."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** a
    return w / w.sum()


def poisson_arrivals(rng: np.random.Generator, rate: float,
                     n: int) -> np.ndarray:
    """Cumulative arrival times of a Poisson process at ``rate``/s —
    exponential inter-arrival gaps, the open-loop admission model."""
    gaps = rng.exponential(1.0 / float(rate), n)
    return np.cumsum(gaps)


def lognormal_sizes(rng: np.random.Generator, mean: float, sigma: float,
                    n: int, lo: int = 1,
                    hi: Optional[int] = None) -> np.ndarray:
    """Heavy-tailed integer sizes (prompt lengths): log-normal with the
    given linear-space ``mean`` (median, strictly: the parameterization
    ``lognormal(log(mean), sigma)``), clipped
    to ``[lo, hi]``."""
    vals = rng.lognormal(np.log(mean), sigma, n).astype(np.int64)
    return np.clip(vals, lo, hi if hi is not None else np.iinfo(np.int64).max)


def lognormal_latencies(rng: np.random.Generator, median_s: float,
                        sigma: float, n: int) -> np.ndarray:
    """Heavy-tailed client latencies in seconds: log-normal with median
    ``median_s`` and shape ``sigma``.  At sigma >= 1.5 the p99/p50 ratio
    exceeds 30x — the cross-device regime where one straggler gates a
    synchronous round."""
    return rng.lognormal(np.log(median_s), sigma, n)


def bernoulli(rng: np.random.Generator, p: float, n: int) -> np.ndarray:
    """n independent coin flips at probability ``p`` (dropout draws)."""
    if p <= 0.0:
        return np.zeros(n, bool)
    return rng.random(n) < p
