"""Field arithmetic of secure aggregation (copy of the part of
``fedml_tpu.core.mpc.secagg`` that TurboAggregate uses): the Mersenne
prime field p = 2³¹ − 1 and the fixed-point map of float vectors into it
and back.  Host-side numpy, bitwise the JAX package's."""

from __future__ import annotations

import numpy as np

P = (1 << 31) - 1  # field prime


def quantize(vec: np.ndarray, scale: float = 1 << 16, p: int = P) -> np.ndarray:
    """float → field: fixed-point with wraparound for negatives."""
    q = np.round(np.asarray(vec, np.float64) * scale).astype(np.int64)
    return np.mod(q, p)


def dequantize(fvec: np.ndarray, scale: float = 1 << 16, p: int = P) -> np.ndarray:
    v = np.asarray(fvec, np.int64)
    v = np.where(v > p // 2, v - p, v)  # recenter
    return (v / scale).astype(np.float32)
