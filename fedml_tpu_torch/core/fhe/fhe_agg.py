"""Homomorphic-encryption aggregation hook (port of
``fedml_tpu.core.fhe.fhe_agg``): encrypt client updates before upload,
aggregate ciphertexts server-side, decrypt the merged model.

Backends (``args.fhe_backend``, registry extensible via
:func:`register_codec`):

- ``"ckks"`` (default) — the RLWE/CKKS-style scheme of
  :mod:`fedml_tpu_torch.core.fhe.ckks`, its ring on the params' device.
- ``"mock"`` — additive masking that only preserves the protocol *shape*
  with zero cryptographic value (host numpy).  Must be requested
  explicitly; selecting it logs a warning.

A params dict flattens in the JAX leaf order and layout
(``security/defense/common.py::tree_flatten_1d``, cast to float32 as the
JAX ``tree_flatten_1d`` does), so the same coefficients land in the same
slots as in the JAX package.

What differs from the JAX module: :meth:`FedMLFHE.init` resets the
singleton first, so a later ``init`` with ``enable_fhe`` off turns
encryption off (the JAX ``init`` returns early and a later run in the same
process stays encrypted); the decrypt template keeps the names, shapes,
dtypes and device of the params last encrypted; the mock's Philox key is
``[seed, size]`` — the JAX mock keys it with four words, which numpy's
``Philox`` refuses, so its ``encrypt`` raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..security.defense.common import tree_flatten_1d, tree_unflatten_1d
from .ckks import CkksCodec, RlweCiphertext

log = logging.getLogger(__name__)


@dataclasses.dataclass
class _Ciphertext:
    """Opaque ciphertext envelope: flat masked vector + bookkeeping."""
    payload: np.ndarray
    n_addends: float = 1


class _AdditiveMaskCodec:
    """Mock-CKKS codec: enc(x) = x + m (mask derived from a key held only by
    clients); ciphertexts add homomorphically; dec subtracts n*m."""

    def __init__(self, seed: int):
        self._seed = seed

    def _mask(self, size: int) -> np.ndarray:
        rng = np.random.Generator(np.random.Philox(key=[self._seed, size]))
        return rng.standard_normal(size).astype(np.float64) * 1e3

    def encrypt(self, vec) -> _Ciphertext:
        if isinstance(vec, torch.Tensor):
            vec = vec.detach().cpu().numpy()
        vec = np.asarray(vec)
        return _Ciphertext(vec.astype(np.float64) + self._mask(vec.size))

    def add(self, a: _Ciphertext, b: _Ciphertext) -> _Ciphertext:
        return _Ciphertext(a.payload + b.payload, a.n_addends + b.n_addends)

    def scale(self, a: _Ciphertext, s: float) -> _Ciphertext:
        # the mask scales too, tracked via fractional n_addends
        return _Ciphertext(a.payload * s, a.n_addends * s)

    def decrypt(self, ct: _Ciphertext) -> np.ndarray:
        return ct.payload - ct.n_addends * self._mask(ct.payload.size)


_CODECS: Dict[str, Callable[[int], Any]] = {
    "ckks": CkksCodec,
    "mock": _AdditiveMaskCodec,
}


def register_codec(name: str, factory: Callable[[int], Any]) -> None:
    """Slot in another HE backend: ``factory(seed) -> codec`` with
    encrypt/add/scale/decrypt."""
    _CODECS[str(name).lower()] = factory


class FedMLFHE:
    _instance = None

    @classmethod
    def get_instance(cls) -> "FedMLFHE":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self):
        self.is_enabled = False
        self.codec = None
        self._template = None

    def init(self, args):
        self.__init__()
        if args is None or not getattr(args, "enable_fhe", False):
            return
        self.is_enabled = True
        backend = str(getattr(args, "fhe_backend", "ckks")).lower()
        if backend not in _CODECS:
            raise ValueError(
                f"unknown fhe_backend {backend!r}; have {sorted(_CODECS)}")
        if backend == "mock":
            log.warning(
                "fhe_backend='mock' provides NO cryptographic protection "
                "(additive masking only) — use the default 'ckks' backend "
                "for real lattice encryption")
        seed = int(getattr(args, "random_seed", 0)) ^ 0xF4E
        self.codec = _CODECS[backend](seed)

    def is_fhe_enabled(self) -> bool:
        return self.is_enabled

    # -- hook surface ------------------------------------------------------
    def fhe_enc(self, enc_type: str, model_params: Dict[str, torch.Tensor]):
        """Encrypt a params dict (on its device, for the ckks codec)."""
        self._template = dict(model_params)
        flat = tree_flatten_1d(model_params).to(torch.float32)
        return self.codec.encrypt(flat)

    def fhe_dec(self, dec_type: str, enc_model_params: Any) -> Any:
        """Decrypt into the template of the last :meth:`fhe_enc`; a
        plaintext (the first round's global model) is returned as is."""
        if not isinstance(enc_model_params, (_Ciphertext, RlweCiphertext)):
            return enc_model_params
        flat = torch.as_tensor(self.codec.decrypt(enc_model_params))
        dev = next(iter(self._template.values())).device
        return tree_unflatten_1d(flat.to(dtype=torch.float32, device=dev),
                                 self._template)

    def fhe_fedavg(self, raw_client_list: List[Tuple[float, Any]]):
        """Weighted FedAvg entirely in ciphertext space."""
        total = float(sum(n for n, _ in raw_client_list))
        acc = None
        for n, ct in raw_client_list:
            scaled = self.codec.scale(ct, n / total)
            acc = scaled if acc is None else self.codec.add(acc, scaled)
        return acc
