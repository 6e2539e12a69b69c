"""RLWE encryption with CKKS-style fixed-point encoding for FL aggregation
(port of ``fedml_tpu.core.fhe.ckks``).

The scheme is the JAX package's, integer for integer:

- Ring: R_q = Z_q[X]/(X^N + 1), N = 2048, q = p1·p2 (two NTT-friendly
  30-bit primes, RNS representation; every product < 2^62).
- Encryption (symmetric RLWE): ct = (c0, c1) with c1 ← U(R_q),
  c0 = −c1·s + e + Δ·m, ternary secret s, rounded-gaussian error e
  (σ = 3.2).  Decrypt: m̃ = c0 + c1·s mod q.
- Encoding: coefficient packing, round(Δ·x_i) into the i-th coefficient.
- Homomorphic ops: ciphertext + ciphertext, and a plaintext scalar
  multiply by an integer weight round(w·2^16) tracked in the scale.

What differs from the JAX module: the JAX ring is host numpy int64 (a TPU
has no int64).  Here the build-time work — the primes, the NTT twiddle
tables, the bit reversal and the secret key's NTT form, derived from the
shared seed — stays on the host, bitwise the JAX tables, while the ring
(``_ResidueNTT._core``/``fwd``/``inv``/``mul``, ``encrypt``, ``add``,
``scale``, ``_crt_center``, ``decrypt``) runs as torch int64 on the device
of the data: the vector given to :meth:`CkksCodec.encrypt` (the card for a
host array) and the tensors of a :class:`RlweCiphertext`.  Every step is
exact integer arithmetic below 2^62 with floor-mod (``%``), so the same
inputs give the same integers on the card, on the CPU and in numpy.

The per-encryption randomness (a, e) comes from OS entropy, never from the
seed: one ``torch.Generator`` per device, seeded from ``os.urandom``.  If
two clients shared a stream, their ciphertexts would subtract to the
plaintext difference.  Every draw goes through :func:`draw`, in the JAX
call order (the error first, then one uniform polynomial per prime), so a
test can replace it with the JAX codec's draws.

SECURITY NOTE (the JAX module's): the parameters follow the
homomorphicencryption.org standard's 128-bit category for this ring size,
but the implementation is minimal and unaudited; production deployments
swap in an audited library through ``fhe_agg.register_codec``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import numpy as np
import torch

N = 2048                 # ring degree (slots per ciphertext chunk)
DELTA_BITS = 30          # fixed-point scale Δ = 2^30
WEIGHT_BITS = 16         # scalar weights quantized to 2^-16
SIGMA = 3.2              # the error's standard deviation


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _find_ntt_primes(count: int, bits: int = 30) -> List[int]:
    """Primes p ≡ 1 (mod 2N) just above 2^bits (so NTT of size 2N exists)."""
    out = []
    p = (1 << bits) + 1
    step = 2 * N
    p += (-(p - 1)) % step  # align p ≡ 1 (mod 2N)
    while len(out) < count:
        if _is_prime(p):
            out.append(p)
        p += step
    return out


def _primitive_2n_root(p: int) -> int:
    """A primitive 2N-th root of unity mod p."""
    order = 2 * N
    for g in range(2, 1000):
        root = pow(g, (p - 1) // order, p)
        if pow(root, order // 2, p) == p - 1:  # order exactly 2N
            return root
    raise RuntimeError("no 2N-th root found")


_PRIMES = _find_ntt_primes(2)
Q = _PRIMES[0] * _PRIMES[1]


def _bitrev_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


_BITREV = _bitrev_indices(N)


class _ResidueNTT:
    """Per-prime negacyclic NTT: host numpy tables (bitwise the JAX
    ones), transforms in torch int64 on the input's device."""

    def __init__(self, p: int):
        self.p = p
        psi = _primitive_2n_root(p)
        w = psi * psi % p                       # primitive N-th root
        self.psi_pows = np.array(
            [pow(psi, i, p) for i in range(N)], dtype=np.int64)
        inv_psi = pow(psi, p - 2, p)
        self.inv_psi_pows = np.array(
            [pow(inv_psi, i, p) for i in range(N)], dtype=np.int64)
        self.inv_n = pow(N, p - 2, p)
        # per-stage twiddles (block half-size m = 1, 2, ..., N/2)
        self.stage_w = []
        self.stage_w_inv = []
        inv_w = pow(w, p - 2, p)
        m = 1
        while m < N:
            exp = N // (2 * m)
            self.stage_w.append(np.array(
                [pow(w, exp * j, p) for j in range(m)], dtype=np.int64))
            self.stage_w_inv.append(np.array(
                [pow(inv_w, exp * j, p) for j in range(m)], dtype=np.int64))
            m *= 2
        self._on: Dict[str, dict] = {}

    def tables(self, device) -> dict:
        """The tables as int64 tensors on ``device`` (copied once)."""
        key = str(torch.device(device))
        t = self._on.get(key)
        if t is None:
            def put(a):
                return torch.as_tensor(a, dtype=torch.int64, device=device)
            t = {"bitrev": put(_BITREV), "psi": put(self.psi_pows),
                 "inv_psi": put(self.inv_psi_pows),
                 "w": [put(a) for a in self.stage_w],
                 "w_inv": [put(a) for a in self.stage_w_inv]}
            self._on[key] = t
        return t

    def _core(self, a: torch.Tensor, stages) -> torch.Tensor:
        p = self.p
        a = a.index_select(-1, self.tables(a.device)["bitrev"])
        for tw in stages:           # m = len(tw) doubles per stage
            m = tw.shape[0]
            # butterflies on (..., N/(2m), 2, m) blocks
            blocks = a.reshape(a.shape[:-1] + (N // (2 * m), 2, m))
            u = blocks[..., 0, :]
            v = blocks[..., 1, :] * tw % p
            a = torch.cat([(u + v) % p, (u - v) % p],
                          dim=-1).reshape(a.shape)
        return a

    def fwd(self, a: torch.Tensor) -> torch.Tensor:
        """Negacyclic forward: psi-twist then NTT.  a: (..., N) in [0, p)."""
        t = self.tables(a.device)
        return self._core(a * t["psi"] % self.p, t["w"])

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        t = self.tables(a.device)
        out = self._core(a, t["w_inv"])
        out = out * self.inv_n % self.p
        return out * t["inv_psi"] % self.p

    def mul(self, a: torch.Tensor, b_hat: torch.Tensor) -> torch.Tensor:
        """a ⊛ b (negacyclic) with b already in NTT domain."""
        return self.inv(self.fwd(a) * b_hat % self.p)


_NTT = [_ResidueNTT(p) for p in _PRIMES]


def draw(gen: torch.Generator, shape, p: int = None) -> torch.Tensor:
    """One draw of an encryption's randomness on ``gen``'s device: the
    error's gaussian before rounding (float64, σ = :data:`SIGMA`), or,
    given ``p``, a uniform polynomial on [0, p) (int64)."""
    if p is None:
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=torch.float64) * SIGMA
    return torch.randint(0, p, shape, generator=gen, device=gen.device,
                         dtype=torch.int64)


@dataclasses.dataclass
class RlweCiphertext:
    """(c0, c1) in RNS: int64 tensors of shape (n_chunks, n_primes, N) on
    one device, plus the total fixed-point scale of the encoded plaintext
    and the original vector length (chunks are zero-padded)."""
    c0: torch.Tensor
    c1: torch.Tensor
    scale: float
    size: int

    @property
    def nbytes(self) -> int:
        return (self.c0.numel() * self.c0.element_size()
                + self.c1.numel() * self.c1.element_size())


class CkksCodec:
    """Keyed codec instance.  In the FL protocol all clients share the
    secret (derived from the shared seed); the server never holds it — it
    only adds and scales ciphertexts."""

    name = "ckks"
    is_cryptographic = True

    def __init__(self, seed: int):
        # ONLY the secret derives from the shared seed; (a, e) come from
        # OS entropy (:meth:`generator`)
        key_rng = np.random.default_rng(seed ^ 0xC1C5)
        s = key_rng.integers(-1, 2, N).astype(np.int64)   # ternary secret
        s_hat = [t.fwd(torch.as_tensor(s % t.p)) for t in _NTT]
        self._s_hat_host = torch.stack(s_hat)
        self._s_hat: Dict[str, torch.Tensor] = {}
        self._gens: Dict[str, torch.Generator] = {}

    @staticmethod
    def _device_of(vec) -> torch.device:
        """The data's device; a host array goes to the card."""
        if isinstance(vec, torch.Tensor):
            return vec.device
        from ...device import get_device
        return get_device(None)

    def s_hat(self, device) -> torch.Tensor:
        """The secret's NTT form (n_primes, N) on ``device``."""
        key = str(torch.device(device))
        if key not in self._s_hat:
            self._s_hat[key] = self._s_hat_host.to(device)
        return self._s_hat[key]

    def generator(self, device) -> torch.Generator:
        """This codec's generator on ``device``, seeded from OS entropy."""
        key = str(torch.device(device))
        gen = self._gens.get(key)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(int.from_bytes(os.urandom(8), "little") >> 1)
            self._gens[key] = gen
        return gen

    # -- helpers -----------------------------------------------------------
    def _poly_mul_s(self, c1: torch.Tensor) -> torch.Tensor:
        """c1·s per chunk/residue; c1: (chunks, n_primes, N)."""
        s_hat = self.s_hat(c1.device)
        return torch.stack([
            _NTT[i].mul(c1[:, i], s_hat[i][None])
            for i in range(len(_NTT))], dim=1)

    def _crt_center(self, r: torch.Tensor) -> torch.Tensor:
        """RNS residues (chunks, 2, N) → centered int64 coefficients."""
        p1, p2 = _PRIMES
        inv_p1 = pow(p1, p2 - 2, p2)
        r1 = r[:, 0]
        r2 = r[:, 1]
        # Garner: x = r1 + p1 * ((r2 - r1) * inv(p1) mod p2)
        t = (r2 - r1) % p2 * inv_p1 % p2
        x = r1 + p1 * t                      # < p1*p2 ≈ 2^61, int64-safe
        return torch.where(x > Q // 2, x - Q, x)

    # -- API ---------------------------------------------------------------
    def encrypt(self, vec) -> RlweCiphertext:
        dev = self._device_of(vec)
        flat = torch.as_tensor(vec).to(device=dev,
                                       dtype=torch.float64).reshape(-1)
        size = flat.numel()
        chunks = -(-size // N)
        delta = float(1 << DELTA_BITS)
        m = torch.zeros(chunks * N, dtype=torch.int64, device=dev)
        m[:size] = torch.round(flat * delta).to(torch.int64)
        m = m.reshape(chunks, N)
        gen = self.generator(dev)
        e = torch.round(draw(gen, (chunks, N))).to(torch.int64)
        s_hat = self.s_hat(dev)
        c0, c1 = [], []
        for i, t in enumerate(_NTT):
            a = draw(gen, (chunks, N), t.p)
            c1.append(a)
            a_s = t.mul(a, s_hat[i][None])
            c0.append((m + e - a_s) % t.p)
        return RlweCiphertext(torch.stack(c0, dim=1), torch.stack(c1, dim=1),
                              delta, size)

    def add(self, a: RlweCiphertext, b: RlweCiphertext) -> RlweCiphertext:
        assert a.size == b.size and a.scale == b.scale
        c0 = torch.stack([(a.c0[:, i] + b.c0[:, i]) % t.p
                          for i, t in enumerate(_NTT)], dim=1)
        c1 = torch.stack([(a.c1[:, i] + b.c1[:, i]) % t.p
                          for i, t in enumerate(_NTT)], dim=1)
        return RlweCiphertext(c0, c1, a.scale, a.size)

    def scale(self, a: RlweCiphertext, s: float) -> RlweCiphertext:
        w = int(round(s * (1 << WEIGHT_BITS)))
        c0 = torch.stack([a.c0[:, i] * (w % t.p) % t.p
                          for i, t in enumerate(_NTT)], dim=1)
        c1 = torch.stack([a.c1[:, i] * (w % t.p) % t.p
                          for i, t in enumerate(_NTT)], dim=1)
        return RlweCiphertext(c0, c1, a.scale * (1 << WEIGHT_BITS), a.size)

    def decrypt(self, ct: RlweCiphertext) -> torch.Tensor:
        """The plaintext as a float64 vector on the ciphertext's device."""
        s_c1 = self._poly_mul_s(ct.c1)
        r = torch.stack([(ct.c0[:, i] + s_c1[:, i]) % t.p
                         for i, t in enumerate(_NTT)], dim=1)
        coeffs = self._crt_center(r)
        return (coeffs.reshape(-1).to(torch.float64) / ct.scale)[: ct.size]
