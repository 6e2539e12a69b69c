"""Secure aggregation primitives (port of ``fedml_tpu.core.mpc.secagg``):
finite-field arithmetic over the Mersenne prime p = 2³¹ − 1, Shamir
share-and-reconstruct, the mask PRGs, pairwise masking and the server's
secure sum; the SecAgg protocol drivers are in ``cross_silo/secagg/``.

Host-side numpy, bitwise the JAX package's: these run at round boundaries
on flattened vectors, where the JAX package runs them, on streams of
``core/hostrng`` and Python integers.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..hostrng import gen as hostgen

P = (1 << 31) - 1  # field prime


def modular_inv(a: int, p: int = P) -> int:
    """Fermat inverse (reference secagg.py:8 uses extended-euclid loop)."""
    return pow(int(a), p - 2, p)


def quantize(vec: np.ndarray, scale: float = 1 << 16, p: int = P) -> np.ndarray:
    """float → field: fixed-point with wraparound for negatives."""
    q = np.round(np.asarray(vec, np.float64) * scale).astype(np.int64)
    return np.mod(q, p)


def dequantize(fvec: np.ndarray, scale: float = 1 << 16, p: int = P) -> np.ndarray:
    v = np.asarray(fvec, np.int64)
    v = np.where(v > p // 2, v - p, v)  # recenter
    return (v / scale).astype(np.float32)


# -- Shamir secret sharing ----------------------------------------------------
def _eval_poly_matrix(coeffs: np.ndarray, xs: Sequence[int], p: int = P):
    """coeffs: (t, D) field matrix (row 0 = secret); returns (len(xs), D)."""
    out = np.zeros((len(xs), coeffs.shape[1]), dtype=np.int64)
    for i, x in enumerate(xs):
        acc = np.zeros(coeffs.shape[1], dtype=np.int64)
        xe = 1
        for row in coeffs:
            acc = (acc + row * xe) % p
            xe = (xe * x) % p
        out[i] = acc
    return out


def shamir_share(secret: np.ndarray, n: int, t: int, seed: int,
                 p: int = P) -> Dict[int, np.ndarray]:
    """Split a field vector into n shares, any t reconstruct (party ids are
    evaluation points 1..n)."""
    rng = hostgen(seed, 0x5A5A)
    coeffs = np.concatenate([
        np.asarray(secret, np.int64)[None, :],
        rng.integers(0, p, size=(t - 1, len(secret)), dtype=np.int64),
    ])
    shares = _eval_poly_matrix(coeffs, list(range(1, n + 1)), p)
    return {i + 1: shares[i] for i in range(n)}


def shamir_reconstruct(shares: Dict[int, np.ndarray], p: int = P) -> np.ndarray:
    """Lagrange interpolation at x=0 over any t shares."""
    xs = list(shares.keys())
    out = np.zeros_like(next(iter(shares.values())))
    for i in xs:
        num, den = 1, 1
        for j in xs:
            if j == i:
                continue
            num = (num * (-j % p)) % p
            den = (den * ((i - j) % p)) % p
        lam = (num * modular_inv(den, p)) % p
        out = (out + shares[i] * lam) % p
    return out


# -- pairwise masking (Bonawitz SecAgg) --------------------------------------
def prg_mask(seed: int, size: int, p: int = P) -> np.ndarray:
    return hostgen(seed, 0x3A5C).integers(0, p, size=size, dtype=np.int64)


def pairwise_mask(client_id: int, peer_ids: Sequence[int], pair_seeds: Dict,
                  size: int, p: int = P) -> np.ndarray:
    """Σ_{j>i} PRG(s_ij) − Σ_{j<i} PRG(s_ji): cancels exactly in the sum over
    all clients (the SecAgg masking identity)."""
    mask = np.zeros(size, dtype=np.int64)
    for j in peer_ids:
        if j == client_id:
            continue
        s = pair_seeds[tuple(sorted((client_id, j)))]
        m = prg_mask(s, size, p)
        mask = (mask + m) % p if client_id < j else (mask - m) % p
    return mask


def masked_input(x: np.ndarray, client_id: int, peer_ids, pair_seeds,
                 self_seed: int, p: int = P) -> np.ndarray:
    """y_i = x_i + b_i + Σ pairwise masks (b_i = self mask, recoverable via
    Shamir shares on dropout)."""
    q = quantize(x, p=p)
    b = prg_mask(self_seed, len(q), p)
    pw = pairwise_mask(client_id, peer_ids, pair_seeds, len(q), p)
    return (q + b + pw) % p


def secure_sum(masked: List[np.ndarray], self_seeds: List[int],
               p: int = P) -> np.ndarray:
    """Server: Σ y_i − Σ b_i (pairwise masks cancel; self masks removed via
    the seeds surrendered/reconstructed in the unmasking round)."""
    total = np.zeros_like(masked[0])
    for y in masked:
        total = (total + y) % p
    for s in self_seeds:
        total = (total - prg_mask(s, len(total), p)) % p
    return total
