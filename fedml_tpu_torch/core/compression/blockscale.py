"""Block-scaled low-precision quantization of flat collective payloads
(port of ``fedml_tpu.core.compression.blockscale``), in torch.

- :func:`blockscale_quantize` / :func:`blockscale_dequantize` — symmetric
  per-chunk-absmax integer quantization of a flat vector (chunk = ``block``
  contiguous elements, one f32 scale per chunk), stochastic rounding when
  noise is given, round-to-nearest otherwise.
- :func:`bf16_stochastic_round` — stochastic rounding f32→bf16 by adding
  random low bits to the u32 encoding, then truncating.
- :func:`collective_quantize` — the precision-dispatched quantize→dequantize
  pair the engines apply to a collective payload; the caller keeps
  ``payload − dequantized`` as the error-feedback residual.
- :func:`quantize_broadcast` — the same for the post-update params
  broadcast, with its own residual at int8.
- the numpy twins of the host codec, copied from the JAX package and
  pinned bitwise against it by a test;
- :func:`collective_payload_nbytes` / :func:`modeled_collective_bytes` —
  the wire-size model.

The rounding noise is explicit: every function that rounds stochastically
takes ``noise``, a ``torch.Generator`` to draw it from or the tensor itself
(uniform ``[0, 1)`` of the ``(blocks, block)`` shape for int8, integers in
``[0, 2**16)`` of the payload's shape for bf16).  ``None`` rounds to
nearest.  The JAX package draws the same distributions from threefry keys;
torch's generators give other bits, so parity tests pass the JAX draws in.

The int8 path dequantizes BEFORE the reduction (there is no mixed int8 x
scale reduction), so the engines reduce f32 values; bf16 payloads are
reduced at bf16.
"""

from __future__ import annotations

import math

import torch

#: accepted values of ``args.collective_precision`` after "auto" resolution
COLLECTIVE_PRECISIONS = ("fp32", "bf16", "int8")

#: default per-chunk absmax block (``args.quant_block``): one f32 scale per
#: 256 int8 elements = 1.6% scale overhead on the wire
DEFAULT_BLOCK = 256


def draw_noise(noise, kind: str, shape, device) -> torch.Tensor:
    """The rounding noise of one payload: ``noise`` itself when it is a
    tensor, else a draw from the generator ``noise``.  ``kind`` "uniform"
    (int8: U[0, 1) f32) or "bits" (bf16: int64 in [0, 2**16))."""
    if isinstance(noise, torch.Tensor):
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"{kind} noise of shape {tuple(noise.shape)} "
                             f"for a payload that needs {tuple(shape)}")
        return noise.to(device)
    if kind == "uniform":
        return torch.rand(shape, generator=noise, device=noise.device
                          ).to(device)
    return torch.randint(0, 1 << 16, shape, generator=noise,
                         device=noise.device, dtype=torch.int64).to(device)


def _pad_to_block(vec: torch.Tensor, block: int):
    n = vec.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        vec = torch.cat([vec, torch.zeros(pad, dtype=vec.dtype,
                                          device=vec.device)])
    return vec.reshape(nb, block), n


def stochastic_round(x: torch.Tensor, noise=None) -> torch.Tensor:
    """Unbiased rounding of non-negative values: ``floor(x + u)`` with
    ``u ~ U[0, 1)`` (E[result] == x); ``noise=None`` rounds to nearest
    (ties to even, as ``jnp.round``)."""
    if noise is None:
        return torch.round(x)
    return torch.floor(x + draw_noise(noise, "uniform", x.shape, x.device))


def blockscale_quantize(vec: torch.Tensor, *, bits: int = 8,
                        block: int = DEFAULT_BLOCK, noise=None):
    """Flat f32 vector → ``(q, scales)``: symmetric per-chunk quantization
    to ``2**(bits-1) - 1`` signed levels, int8 storage for bits<=8 else
    int16.  Stochastic rounding when ``noise`` is given."""
    levels = (1 << (bits - 1)) - 1
    store = torch.int8 if bits <= 8 else torch.int16
    chunks, _ = _pad_to_block(vec.to(torch.float32), block)
    scales = torch.clamp_min(torch.amax(torch.abs(chunks), dim=1),
                             1e-12) / levels
    q = chunks / scales[:, None]
    q = torch.sign(q) * stochastic_round(torch.abs(q), noise)
    q = torch.clamp(q, -levels, levels).to(store)
    return q, scales.to(torch.float32)


def blockscale_dequantize(q: torch.Tensor, scales: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Inverse of :func:`blockscale_quantize`: f32 vector of length ``n``."""
    x = q.to(torch.float32) * scales[:, None].to(torch.float32)
    return x.reshape(-1)[:n]


def bf16_stochastic_round(x: torch.Tensor, noise=None) -> torch.Tensor:
    """f32 → bf16.  With noise: a random 16-bit add on the u32 encoding,
    then truncation (a carry into the kept bits IS the round-up path, so
    E[result] == x); without: round-to-nearest-even."""
    x = x.to(torch.float32)
    if noise is None:
        return x.to(torch.bfloat16)
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + draw_noise(noise, "bits", x.shape, x.device)) \
        & 0xFFFF0000
    bits = torch.where(bits >= (1 << 31), bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32).to(torch.bfloat16)


def collective_quantize(vec: torch.Tensor, precision: str, noise=None,
                        block: int = DEFAULT_BLOCK):
    """Quantize→dequantize a flat f32 collective payload at ``precision``.

    Returns ``(deq, err_sq)``: the f32 values the collective moves (for
    bf16 exactly bf16-representable, so a later cast to bf16 is lossless)
    and the squared L2 norm of the residual ``vec − deq`` the caller keeps
    in its error-feedback buffer.  ``precision="fp32"`` is the
    identity."""
    x = vec.to(torch.float32)
    if precision == "fp32":
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    if precision == "bf16":
        deq = bf16_stochastic_round(x, noise).to(torch.float32)
    elif precision == "int8":
        q, scales = blockscale_quantize(x, bits=8, block=block, noise=noise)
        deq = blockscale_dequantize(q, scales, x.shape[0])
    else:
        raise ValueError(f"unknown collective precision {precision!r}")
    err = x - deq
    return deq, torch.sum(err * err)


def quantize_broadcast(master: torch.Tensor, ef, precision: str, noise=None,
                       block: int = DEFAULT_BLOCK):
    """Quantize the flat fp32 master params for the post-update broadcast.

    Returns ``(send, new_ef, err_sq)``: the f32 values the all-gather
    moves, the updated broadcast EF residual (unchanged unless int8), and
    the squared residual norm.  bf16 rounds to nearest (no EF, no noise):
    each round re-rounds from fp32, so the error does not accumulate.
    int8's step is large enough that the residual is fed back (``ef``)."""
    x = master.to(torch.float32)
    if precision == "fp32":
        return x, ef, torch.zeros((), dtype=torch.float32, device=x.device)
    if precision == "bf16":
        deq = bf16_stochastic_round(x).to(torch.float32)
        err = x - deq
        return deq, ef, torch.sum(err * err)
    v = x + ef
    deq, err_sq = collective_quantize(v, precision, noise, block)
    return deq, v - deq, err_sq


# -- host-side (numpy) mirrors ----------------------------------------------
#
# Copied from the JAX package for the host codec (the quantized wire),
# which quantizes on the host; tests/test_torch_mesh_quant.py pins each one
# bitwise against the original.

def blockscale_quantize_np(vec, *, bits: int = 8, block: int = DEFAULT_BLOCK):
    """Numpy mirror of :func:`blockscale_quantize` with round-to-nearest
    (the ``key=None`` path).  Returns ``(q, scales)`` with ``q`` shaped
    ``(ceil(n/block), block)``."""
    import numpy as np
    levels = (1 << (bits - 1)) - 1
    store = np.int8 if bits <= 8 else np.int16
    x = np.asarray(vec, np.float32).reshape(-1)
    n = x.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        x = np.concatenate([x, np.zeros((pad,), np.float32)])
    chunks = x.reshape(nb, block)
    scales = np.maximum(np.max(np.abs(chunks), axis=1), 1e-12) / levels
    q = chunks / scales[:, None]
    q = np.sign(q) * np.round(np.abs(q))
    q = np.clip(q, -levels, levels).astype(store)
    return q, scales.astype(np.float32)


def blockscale_dequantize_np(q, scales, n: int):
    """Numpy mirror of :func:`blockscale_dequantize`."""
    import numpy as np
    x = np.asarray(q, np.float32) * np.asarray(scales,
                                               np.float32)[:, None]
    return x.reshape(-1)[:n]


def bf16_round_np(vec):
    """f32 → bf16 bit pattern (uint16) with round-to-nearest-even — the
    numpy twin of ``jnp.asarray(x).astype(bfloat16)``; the codec ships
    the raw 16-bit payload and :func:`bf16_expand_np` restores f32."""
    import numpy as np
    bits = np.asarray(vec, np.float32).reshape(-1).view(np.uint32)
    # RNE: add 0x7FFF plus the parity of the kept LSB, then truncate
    bias = np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    return ((bits + bias) >> np.uint32(16)).astype(np.uint16)


def bf16_expand_np(h):
    """Inverse of :func:`bf16_round_np`: uint16 bf16 bits → f32."""
    import numpy as np
    return (np.asarray(h, np.uint16).astype(np.uint32)
            << np.uint32(16)).view(np.float32)


# -- wire-size model ---------------------------------------------------------

def collective_payload_nbytes(n: int, precision: str,
                              block: int = DEFAULT_BLOCK) -> int:
    """Wire bytes of one n-element payload at ``precision``.

    int8 counts the per-chunk f32 scale arrays AND the block padding:
    :func:`blockscale_quantize` materializes ``q`` padded to a whole
    number of ``block``-element chunks, so the wire format ships
    ``ceil(n/block) * block`` int8 values."""
    if precision == "fp32":
        return 4 * n
    if precision == "bf16":
        return 2 * n
    if precision == "int8":
        nb = math.ceil(n / block)
        return nb * block + 4 * nb
    raise ValueError(f"unknown collective precision {precision!r}")


def modeled_collective_bytes(n_flat: int, n_shards: int, precision: str,
                             block: int = DEFAULT_BLOCK,
                             update_sharding: str = "scatter") -> int:
    """Modeled interconnect payload bytes per round for the mesh engine's
    two hot-path collectives:

    - ``scatter``: reduce-scatter of the EF-quantized FedAvg numerator
      (``n_flat`` elements) + all-gather of the quantized new params
      (``n_shards`` chunks of ``n_flat/n_shards``, each block-scaled
      independently in int8 mode).
    - ``replicated``: one all-reduce of the quantized numerator.

    Payload bytes entering the collectives; topology factors like the ring
    ``(N−1)/N`` cancel in fp32-vs-quantized ratios, so they are
    omitted."""
    merge = collective_payload_nbytes(n_flat, precision, block)
    if update_sharding != "scatter":
        return merge
    chunk = -(-n_flat // max(n_shards, 1))
    bcast = n_shards * collective_payload_nbytes(chunk, precision, block)
    return merge + bcast
