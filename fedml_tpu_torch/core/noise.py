"""Seeded noise of the trust stack: the attacks, the noising defenses and
differential privacy.

The JAX package draws this noise from threefry keys
(``jax.random.PRNGKey(random_seed ^ tag)``, split per draw), which PyTorch
cannot reproduce (``core/rng.py``).  The port keeps one seeded
``torch.Generator`` per purpose and per device, seeded from the same
``random_seed`` and the same tag as the JAX key of that purpose, and every
site draws through :func:`draw`: one call per JAX draw, with the JAX
draw's shape (a leaf in flax's layout, or the flat ``(D,)`` vector), in
the JAX draw order.  A parity test replaces :func:`draw` (the module
attribute) with one that returns the JAX package's own draws, so the rest
of each site's arithmetic is held to the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

#: purpose → how its seed derives from ``random_seed`` (the JAX key's tag)
_TAGS = {
    "dp": ("add", 0xD9),          # core/dp/fedml_differential_privacy.py
    "byzantine": ("xor", 0xB72),  # attack/byzantine_attack.py
    "lazy_worker": ("xor", 0x1A2),
    "weak_dp": ("xor", 0xDEF),    # defense/clipping.py
    "crfl": ("xor", 0xC4F1),
    "dlg": ("xor", 0xD16),        # attack/gradient_inversion.py
}

#: the uniform draw of a Laplace sample stays this far inside (-1, 1)
_LAPLACE_EPS = float(torch.finfo(torch.float32).eps)


class NoiseSource:
    """The generators of one purpose, seeded from ``random_seed``: one per
    device, made at its first draw there."""

    def __init__(self, purpose: str, random_seed: int):
        if purpose not in _TAGS:
            raise ValueError(f"unknown noise purpose {purpose!r}; have "
                             f"{sorted(_TAGS)}")
        op, tag = _TAGS[purpose]
        seed = int(random_seed)
        self.purpose = purpose
        self.seed = (seed + tag) if op == "add" else (seed ^ tag)
        self._gens: Dict[str, torch.Generator] = {}

    def generator(self, device) -> torch.Generator:
        device = torch.device(device)
        key = str(device)
        gen = self._gens.get(key)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(self.seed & 0xFFFF_FFFF_FFFF_FFFF)
            self._gens[key] = gen
        return gen


def draw(source: NoiseSource, shape: Sequence[int], device,
         kind: str = "normal", dtype=torch.float32) -> torch.Tensor:
    """One noise draw of ``shape`` on ``device`` from ``source``: a
    standard normal, or a standard Laplace (``kind="laplace"``:
    ``sign(u) · log1p(−|u|)`` of a uniform ``u`` on (-1, 1), as
    ``jax.random.laplace``)."""
    gen = source.generator(device)
    shape = tuple(int(s) for s in shape)
    if kind == "normal":
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)
    if kind == "laplace":
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32) * 2.0 - 1.0
        u = u.clamp(-1.0 + _LAPLACE_EPS, 1.0 - _LAPLACE_EPS)
        return (torch.sign(u) * torch.log1p(-u.abs())).to(dtype)
    raise ValueError(f"unknown noise kind {kind!r}")
