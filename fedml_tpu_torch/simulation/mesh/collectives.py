"""Mesh collectives: the wire dtype of the federated round's quantized
payloads and the modeled interconnect bytes per mesh axis (port of
``fedml_tpu.simulation.mesh.collectives``).

:func:`wire_cast` gives the payload dtype of a quantized collective: bf16
values move and are summed at bf16; int8 payloads are dequantized before
the reduction, so it runs in f32.  :func:`client_axis_bytes`,
:func:`stage_axis_bytes` and :func:`model_axis_bytes` are the JAX
package's byte model, line for line (``MeshFedAvgAPI.collective_bytes``
applies it).

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

from ...core.compression import blockscale


def wire_cast(v: torch.Tensor, precision: str) -> torch.Tensor:
    """Payload dtype of a quantized collective: bf16 moves and sums at
    bf16; int8 payloads are dequantized before the collective (there is
    no mixed int8 x scale reduction), so they reduce in f32."""
    return v.to(torch.bfloat16) if precision == "bf16" else v


def client_axis_bytes(n_flat: int, n_client_shards: int, precision: str,
                      quant_block: int, mode: str) -> float:
    """Payload bytes a round of the ``client``-axis merge (and the scatter
    layout's broadcast) at this precision
    (``blockscale.modeled_collective_bytes``)."""
    return float(blockscale.modeled_collective_bytes(
        n_flat, n_client_shards, precision, quant_block, mode))


def stage_axis_bytes(n_flat: int, n_stage_shards: int,
                     param_bytes: int = 4, mode: str = "scatter",
                     hidden: int = 0, microbatch: int = 0,
                     n_micro: int = 0, steps: int = 0) -> float:
    """Payload bytes a round crossing the ``stage`` axis on the 3-D
    pipeline layout.  The merge plane: in the scatter layout two flat-view
    moves of ``(s-1)/s`` of the flat length each (zero replicated: the
    params rest stage-sharded).  The train plane: every schedule tick
    moves one ``(microbatch, hidden)`` f32 activation a rank around the
    stage ring, ``n_micro + s - 1`` ticks a local step, and the backward
    moves the gradients back (the 2), ``steps`` local steps a round; the
    bubble ticks move full payloads too.  Zero when ``s == 1``."""
    if n_stage_shards <= 1:
        return 0.0
    merge = (2.0 * float(n_flat) * (n_stage_shards - 1) / n_stage_shards
             * float(param_bytes)) if mode == "scatter" else 0.0
    ticks = n_micro + n_stage_shards - 1
    train = (2.0 * float(ticks) * float(microbatch) * float(hidden)
             * float(param_bytes) * float(steps))
    return merge + train


def model_axis_bytes(n_flat: int, n_model_shards: int,
                     param_bytes: int = 4, mode: str = "scatter") -> float:
    """Payload bytes a round crossing the ``model`` axis on the 2-D
    layout.  ``scatter``: two flat-view moves a round (the model-sharded
    params gathered into the flat numerator's view, and the new params'
    flat chunks back into each rank's leaf shards), each ``(m-1)/m`` of
    the flat length.  ``replicated``: zero (each leaf's shard reduces over
    ``client`` and the params rest sharded).  A lower bound: the
    activations' all-reduces inside a tensor-parallel step are not
    priced.  Zero on the 1-D layout."""
    if n_model_shards <= 1 or mode != "scatter":
        return 0.0
    return 2.0 * float(n_flat) * (n_model_shards - 1) / n_model_shards \
        * float(param_bytes)
