"""Mesh collectives: the wire dtype of the federated round's quantized
payloads (port of ``fedml_tpu.simulation.mesh.collectives``).

:func:`wire_cast` gives the payload dtype of a quantized collective: bf16
values move and are summed at bf16; int8 payloads are dequantized before
the reduction, so it runs in f32.

The rest of the JAX module lives where the port's callers are: its
``psum_wavg`` is ``core/federated.py::PsumReducer``; its per-shard keys
(``shard_qkeys``/``slot_key``) are ``round_engine.noise_source(generator,
shard)``, one child generator per shard and then per slot, so a shard's
draws do not depend on which rank runs it; its ``quantize_ef`` is
``round_engine.ef_numerator`` (the sp engine's too), its
``quantize_broadcast`` and byte models are
``core/compression/blockscale.py``'s.

bf16 reductions: NCCL sums bf16 natively on the card, gloo sums bf16 on
the CPU (each add rounded to bf16).  With two shards that is one add,
bitwise the JAX package's; with more, the order of the adds is the
backend's (ring or tree), so the sums may differ from XLA's in the last
bf16 bit.
"""

from __future__ import annotations

import torch


def wire_cast(v: torch.Tensor, precision: str) -> torch.Tensor:
    """Payload dtype of a quantized collective: bf16 moves and sums at
    bf16; int8 payloads are dequantized before the collective (there is
    no mixed int8 x scale reduction), so they reduce in f32."""
    return v.to(torch.bfloat16) if precision == "bf16" else v
