"""LightSecAgg (port of ``fedml_tpu.core.mpc.lightsecagg``).

One-shot-reconstruction secure aggregation: each client pads its quantized
update, splits it into ``d / (U−T)`` sub-vectors, MDS-encodes them with a
Vandermonde code into N coded shares (T of them masking randomness), and
sends share j to client j.  Each surviving client returns the SUM of the
shares it holds; the server decodes the aggregate from any U such sums —
dropout tolerance without per-pair seed agreements.

Host-side numpy, bitwise the JAX package's.  What differs: the server's
decode (:func:`decode_aggregate_mask`, and step 4 of
:func:`lightsecagg_round`) inverts the U×U Vandermonde matrix once by
:func:`_solve_field` (Python integers) and applies the inverse to the
``(U, block)`` shares in int64 numpy, one product below 2^62 at a time;
the JAX module eliminates on the whole ``(U, block)`` object array.  The
solution mod p is unique, so the two give the same integers
(``tests/test_torch_secagg.py`` pins them), at a fraction of the host
time for a model-sized block.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..hostrng import gen as hostgen
from .secagg import P, modular_inv, quantize, dequantize


def _vandermonde(xs: Sequence[int], k: int, p: int = P) -> np.ndarray:
    V = np.zeros((len(xs), k), dtype=np.int64)
    for i, x in enumerate(xs):
        e = 1
        for j in range(k):
            V[i, j] = e
            e = (e * x) % p
    return V


def _solve_field(A: np.ndarray, B: np.ndarray, p: int = P) -> np.ndarray:
    """Gaussian elimination over GF(p): solve A X = B."""
    A = A.astype(object) % p
    B = B.astype(object) % p
    n = A.shape[0]
    for col in range(n):
        piv = next(r for r in range(col, n) if A[r, col] % p != 0)
        if piv != col:
            A[[col, piv]] = A[[piv, col]]
            B[[col, piv]] = B[[piv, col]]
        inv = modular_inv(int(A[col, col]), p)
        A[col] = (A[col] * inv) % p
        B[col] = (B[col] * inv) % p
        for r in range(n):
            if r != col and A[r, col] % p != 0:
                f = A[r, col]
                A[r] = (A[r] - f * A[col]) % p
                B[r] = (B[r] - f * B[col]) % p
    return B.astype(np.int64)


def _apply_inverse(A: np.ndarray, B: np.ndarray, p: int = P) -> np.ndarray:
    """Solve A X = B over GF(p) for a wide B: A⁻¹ by :func:`_solve_field`,
    then X = A⁻¹ B in int64, reduced after each product (< 2^62)."""
    n = A.shape[0]
    inv = _solve_field(A, np.eye(n, dtype=np.int64), p)
    B = np.asarray(B, np.int64) % p
    X = np.zeros_like(B)
    for i in range(n):
        acc = np.zeros(B.shape[1], dtype=np.int64)
        for j in range(n):
            acc = (acc + int(inv[i, j]) * B[j]) % p
        X[i] = acc
    return X


def mask_encoding(d: int, N: int, U: int, T: int, local_mask: np.ndarray,
                  seed: int, p: int = P) -> Dict[int, np.ndarray]:
    """Encode client's padded mask into N coded shares: data blocks
    F_1..F_{U−T} plus T random blocks, Vandermonde-evaluated at N
    points."""
    k = U - T
    block = -(-d // k)
    padded = np.zeros(k * block, dtype=np.int64)
    padded[:d] = local_mask[:d] % p
    blocks = padded.reshape(k, block)
    rng = hostgen(seed, 0x1B5A)
    noise = rng.integers(0, p, size=(T, block), dtype=np.int64)
    gen_matrix = np.concatenate([blocks, noise])          # (U, block)
    V = _vandermonde(list(range(1, N + 1)), U, p)         # (N, U)
    shares = (V @ gen_matrix) % p
    return {j + 1: shares[j] for j in range(N)}


def aggregate_shares(share_lists: List[np.ndarray], p: int = P) -> np.ndarray:
    """Each surviving client sums the shares it received (one field add)."""
    out = np.zeros_like(share_lists[0])
    for s in share_lists:
        out = (out + s) % p
    return out


def decode_aggregate_mask(agg_shares: Dict[int, np.ndarray], d: int, U: int,
                          p: int = P) -> np.ndarray:
    """From any U aggregated shares, solve for the U generator blocks of the
    SUM mask and read off the data blocks (one-shot reconstruction)."""
    ids = sorted(agg_shares.keys())[:U]
    V = _vandermonde(ids, U, p)
    B = np.stack([agg_shares[i] for i in ids])
    return _apply_inverse(V, B, p)           # (U, block): data rows first


def lightsecagg_round(updates: List[np.ndarray], N: int, U: int, T: int,
                      survivors: Sequence[int], seed: int = 0, p: int = P
                      ) -> np.ndarray:
    """The whole protocol in one process: returns the exact SUM of updates
    while the server only ever sees masked vectors and aggregate shares."""
    d = len(updates[0])
    k = U - T
    block = -(-d // k)
    # 1) each client quantizes + masks its update with a private mask z_i
    masks = [hostgen(seed, 0x2222, i).integers(0, p, size=k * block,
                                               dtype=np.int64)
             for i in range(N)]
    masked = [(quantize(u, p=p) + m[:d]) % p for u, m in zip(updates, masks)]
    # 2) every client encodes its mask and distributes shares
    all_shares = [mask_encoding(k * block, N, U, T, m, seed + i, p)
                  for i, m in enumerate(masks)]
    # 3) survivors sum the shares they hold (from surviving sources);
    #    client i holds evaluation point i+1
    agg_shares = {}
    for j in survivors:
        agg_shares[j + 1] = aggregate_shares(
            [all_shares[i][j + 1] for i in survivors], p)
    # 4) server: sum of surviving masked updates − decoded sum-mask
    total_masked = np.zeros(d, dtype=np.int64)
    for i in survivors:
        total_masked = (total_masked + masked[i]) % p
    G = decode_aggregate_mask(agg_shares, d, U, p)
    sum_mask = G[:k].reshape(-1)[:d]
    total = (total_masked - sum_mask) % p
    return dequantize(total, p=p)
