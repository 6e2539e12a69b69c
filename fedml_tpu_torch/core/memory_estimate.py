"""Device-memory upper bounds for the serving engine (port of
``fedml_tpu.core.memory_estimate``'s two serving estimators; the training
layouts are not ported).  Counts from shapes only, so they run anywhere; the
card's ``torch.cuda.max_memory_allocated`` is what they are held against."""

from __future__ import annotations

from typing import Dict

GIB = 1024 ** 3


def estimate_serving_memory(*, n_params: float, n_slots: int,
                            cache_bytes: float, vocab_size: int,
                            horizon: int = 1, param_bytes: int = 4,
                            bank_bytes: float = 0.0,
                            safety: float = 1.25) -> Dict[str, float]:
    """Upper bound for the continuous-batching engine's batched decode
    step: the weights, the per-slot KV caches (``cache_bytes``, exact from
    the engine's cache), the adapter bank, and a working set of one cache
    copy plus per-slot logits across the decode horizon."""
    params = float(n_params) * param_bytes
    logits = float(n_slots) * vocab_size * 4.0 * max(1, int(horizon))
    work = float(cache_bytes) + logits + params * 0.25
    total = (params + float(cache_bytes) + float(bank_bytes)
             + work) * safety
    return {
        "params": params,
        "kv_caches": float(cache_bytes),
        "adapter_bank": float(bank_bytes),
        "step_work": work,
        "total": total,
        "total_gib": total / GIB,
    }


def estimate_paged_serving_memory(*, n_params: float, n_slots: int,
                                  pool_bytes: float,
                                  block_table_bytes: float,
                                  window_bytes: float, vocab_size: int,
                                  horizon: int = 1, param_bytes: int = 4,
                                  bank_bytes: float = 0.0,
                                  safety: float = 1.25) -> Dict[str, float]:
    """Upper bound for the paged engine's decode step: the page pool
    (``pool_bytes``, exact) is written in place, so the working set prices
    no cache copy, only the per-layer gather window (``window_bytes``:
    ``n_slots x kv_heads x max_blocks*page_tokens x head_dim`` K+V for ~2
    live layers), block tables and logits."""
    params = float(n_params) * param_bytes
    logits = float(n_slots) * vocab_size * 4.0 * max(1, int(horizon))
    work = float(window_bytes) + logits + params * 0.25
    total = (params + float(pool_bytes) + float(block_table_bytes)
             + float(bank_bytes) + work) * safety
    return {
        "params": params,
        "kv_pool": float(pool_bytes),
        "block_tables": float(block_table_bytes),
        "gather_window": float(window_bytes),
        "adapter_bank": float(bank_bytes),
        "step_work": work,
        "total": total,
        "total_gib": total / GIB,
    }
