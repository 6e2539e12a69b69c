"""Host-side deterministic RNG streams (copy of ``fedml_tpu.core.hostrng``).

Device randomness uses seeded ``torch.Generator``s (core/rng.py); host-side
batching / partitioning / sampling uses numpy Philox generators keyed by
arbitrary integer tuples.  ``gen(*words)`` mixes the words into Philox's
2×uint64 key (splitmix64) so every (seed, round, client, purpose) tuple gets
an independent, platform-stable stream — bitwise the JAX package's streams.
"""

from __future__ import annotations

import numpy as np

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def gen(*words: int) -> np.random.Generator:
    h1, h2 = 0x243F6A8885A308D3, 0x13198A2E03707344
    for w in words:
        w = int(w) & _MASK
        h1 = _splitmix64(h1 ^ w)
        h2 = _splitmix64((h2 + w) & _MASK)
    key = np.array([h1, h2], dtype=np.uint64)
    return np.random.Generator(np.random.Philox(key=key))
