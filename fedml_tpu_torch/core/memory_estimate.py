"""Device-memory upper bounds (port of ``fedml_tpu.core.memory_estimate``):
the federated-LoRA round's layout over a ``client × model`` mesh
(:class:`FedLLMLayout`), the mesh engine's per-rank state
(:class:`MeshStateLayout`), one round's footprint, and the serving
engine's decode step.  Counts from shapes only, so they run anywhere; the
card's ``torch.cuda.max_memory_allocated`` is what they are held against.

All numbers are bytes unless suffixed ``_gib``.  The closed forms are the
JAX package's, line for line; the chip table is not: it holds the one
card the port runs on, an H100 80 GB HBM3 at 700 W, at the same 0.75
usable share the JAX table keeps for scratch and fragmentation (the TPU
rows are not carried over).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

GIB = 1024 ** 3

#: usable device memory per card (device-name substring -> bytes)
HBM_PER_CHIP = {
    "h100": int(80 * 0.75 * GIB),
}


@dataclasses.dataclass
class FedLLMLayout:
    """Mesh layout for a LoRA federation round."""
    n_params: float              # base model parameter count
    n_lora_params: float         # adapter parameter count PER CLIENT
    n_clients: int               # cohort size per round
    n_chips: int                 # total chips in the mesh
    model_shards: int            # tensor/FSDP shard count (model axis)
    batch_per_client: int = 1
    seq_len: int = 2048
    dim: int = 4096
    n_layers: int = 32
    param_bytes: int = 2         # bf16 base weights
    lora_bytes: int = 4          # fp32 adapters
    optimizer_slots: int = 2     # adam m+v over adapters
    safety: float = 1.25
    #: llm.model.LlamaConfig.remat — "full" keeps only block-boundary
    #: activations; "dots" additionally saves each layer's matmul outputs
    #: (q/k/v/o + gate/up/down), trading HBM for ~25-30% less backward
    #: recompute; "none" saves every intermediate (priced like dots +
    #: attention workspaces — a coarse upper bound)
    remat: str = "full"
    ffn_dim: int = 11008
    kv_dim: int = 4096           # n_kv_heads * head_dim

    @property
    def client_shards(self) -> int:
        return max(1, self.n_chips // self.model_shards)

    @property
    def clients_per_chip_group(self) -> int:
        return -(-self.n_clients // self.client_shards)


def estimate_fedllm_memory(layout: FedLLMLayout) -> Dict[str, float]:
    """Per-chip HBM breakdown for one federated LoRA round."""
    lo = layout
    base = lo.n_params * lo.param_bytes / lo.model_shards
    per_client_state = lo.n_lora_params * lo.lora_bytes * (
        1 + 1 + lo.optimizer_slots)          # adapters + grads + opt slots
    adapters = per_client_state * lo.clients_per_chip_group
    # remat at block boundaries: one (B, S, dim) bf16 tensor per layer per
    # resident client microbatch, plus ~4 working tensors for the live block
    act_per_client = (lo.n_layers + 4) * (
        lo.batch_per_client * lo.seq_len * lo.dim * 2) / lo.model_shards
    if lo.remat in ("dots", "none"):
        # saved matmul outputs per layer per token: q + o (dim each),
        # k + v (kv_dim each), gate + up (ffn_dim each), down (dim)
        saved_per_tok = 3 * lo.dim + 2 * lo.kv_dim + 2 * lo.ffn_dim
        act_per_client += lo.n_layers * (
            lo.batch_per_client * lo.seq_len * saved_per_tok * 2
        ) / lo.model_shards
        if lo.remat == "none":
            # attention workspaces + norms kept too; coarse 1.5x on the
            # per-layer saved set (flash never materializes S x S)
            act_per_client *= 1.5
    activations = act_per_client  # clients run scanned, one live at a time
    # psum/all-gather scratch: one adapter set + one activation buffer
    scratch = lo.n_lora_params * lo.lora_bytes + act_per_client
    total = (base + adapters + activations + scratch) * lo.safety
    return {
        "base_params": base,
        "adapter_states": adapters,
        "activations": activations,
        "collective_scratch": scratch,
        "total": total,
        "total_gib": total / GIB,
        "clients_per_chip_group": lo.clients_per_chip_group,
        "client_shards": lo.client_shards,
    }


def fits(layout: FedLLMLayout, chip: str = "h100") -> bool:
    budget = None
    for marker, b in HBM_PER_CHIP.items():
        if marker in chip.lower():
            budget = b
            break
    if budget is None:
        raise ValueError(f"unknown chip {chip!r}; have {list(HBM_PER_CHIP)}")
    return estimate_fedllm_memory(layout)["total"] <= budget


# -- mesh-engine state estimate (2-D client × model layout) ------------------

#: flat f32 aux vectors ``ServerOptimizer.init_sharded`` allocates per
#: algorithm (docs/UPDATE_SHARDING.md): FedOpt's Adam m+v, SCAFFOLD's
#: c_server, FedDyn's h, Mime's momentum
OPT_FLAT_SLOTS = {
    "fedavg": 0, "fedsgd": 0, "fedopt": 2, "scaffold": 1, "feddyn": 1,
    "fednova": 0, "mime": 1,
}


@dataclasses.dataclass
class MeshStateLayout:
    """What ``MeshFedAvgAPI`` keeps resident per chip for one model
    (docs/MESH_2D.md): the broadcast params copy, the shard-resident flat
    server state, the quantized-collective buffers, and the vmapped
    cohort's per-client params copies.  ``mesh_shape`` is
    ``(n_client_shards, n_model_shards)`` or the 3-D pipeline form
    ``(n_client_shards, n_stage_shards, n_model_shards)`` —
    ``args.mesh_shape`` (docs/PIPELINE.md).

    The ``max_*_parallel`` bounds encode the model's DIVISIBILITY
    ceilings, mirroring ``MeshLayout.param_spec``'s guard (a leaf only
    shards a dim the shard count divides): ``max_model_parallel`` is the
    largest useful ``model`` factor (≈ the hidden width — beyond it,
    extra model shards hold replicated leaf copies and stop reducing the
    params plane) and ``max_stage_parallel`` the largest useful ``stage``
    factor (the stacked layer depth).  0 = unbounded (the historical 2-D
    behavior).  ``stage_fraction`` is the fraction of ``n_params`` living
    in the staged leaves on the 3-D layout (embed/head replicate over
    stage AND model — docs/PIPELINE.md); ignored when ``s == 1``."""
    n_params: float
    mesh_shape: tuple = (8, 1)
    clients_per_round: int = 8
    algorithm: str = "fedavg"
    collective_precision: str = "fp32"
    param_bytes: int = 4         # f32 params (the LR/MLP zoo); LLMs pass 2
    safety: float = 1.25
    stage_fraction: float = 1.0
    max_model_parallel: int = 0
    max_stage_parallel: int = 0

    @property
    def n_client_shards(self) -> int:
        return int(self.mesh_shape[0])

    @property
    def n_stage_shards(self) -> int:
        return int(self.mesh_shape[1]) if len(self.mesh_shape) == 3 else 1

    @property
    def n_model_shards(self) -> int:
        return int(self.mesh_shape[-1])

    @property
    def eff_model(self) -> int:
        """Model factor actually reducing per-leaf bytes (divisibility)."""
        m = self.n_model_shards
        return min(m, self.max_model_parallel) if self.max_model_parallel \
            else m

    @property
    def eff_stage(self) -> int:
        s = self.n_stage_shards
        return min(s, self.max_stage_parallel) if self.max_stage_parallel \
            else s


def estimate_mesh_state_memory(lo: MeshStateLayout) -> Dict[str, float]:
    """Per-chip HBM of the mesh engine's persistent + round-resident state.

    The 2-D unlock this prices (docs/MESH_2D.md): everything that scales
    with the model divides by ``n_model_shards`` — params/cohort copies
    because matrices shard per ``MeshLayout.param_spec``, the flat server
    state (opt moments, fp32 master, broadcast EF) because flat vectors
    chunk over BOTH axes (each chip owns ``1/(c*m)``), and the per-shard
    EF rows because their columns shard over ``model``.  On the 1-D layout
    (``m == 1``) params replicate and one client's model must fit in one
    chip's HBM — the ceiling this estimator makes visible.

    On the 3-D pipeline layout (``mesh_shape`` a 3-tuple with a stage
    factor, docs/PIPELINE.md) the STAGED fraction of the params/cohort
    plane divides by the effective ``stage × model`` product (layer
    chunks over ``stage``, rows over ``model``) while the non-staged
    remainder (embed/head) replicates over both; flat aux vectors chunk
    over all three axes with no divisibility ceiling (they pad)."""
    c, s, m = lo.n_client_shards, lo.n_stage_shards, lo.n_model_shards
    flat = -(-int(lo.n_params) // (c * s * m)) * (c * s * m)  # padded flat
    quantized = lo.collective_precision != "fp32"
    if s > 1:
        # staged leaves divide by the EFFECTIVE s*m (divisibility-bounded);
        # embed/head replicate over stage and model
        sf = min(max(float(lo.stage_fraction), 0.0), 1.0)
        leaf_div = 1.0 / (sf / (lo.eff_stage * lo.eff_model) + (1.0 - sf))
    else:
        # historical 2-D rule: matrix leaves shard one dim over ``model``
        leaf_div = float(lo.eff_model)
    # broadcast params copy the clients train from: replicated on 1-D,
    # leaf-sharded per the model (and stage) rules otherwise
    params = lo.n_params * lo.param_bytes / leaf_div
    # scatter-mode flat aux state, f32, each chip owns 1/(c*s*m)
    n_flat_slots = OPT_FLAT_SLOTS.get(lo.algorithm.lower(), 2)
    if quantized:
        n_flat_slots += 2            # master_flat + ef_bcast
    opt_state = n_flat_slots * 4.0 * flat / (c * s * m)
    # per-shard EF rows: one (flat,) row per client shard, columns over
    # the stage/model axes
    ef_rows = (4.0 * flat / (s * m)) if quantized else 0.0
    # vmapped cohort: each client shard trains its cohort slice, and every
    # live client's params/update copy (outs.params) follows the leaf rules
    clients_per_shard = -(-lo.clients_per_round // c)
    cohort = clients_per_shard * lo.n_params * 4.0 / leaf_div
    # merge scratch: the flat numerator + one reduce-scattered chunk
    scratch = 4.0 * flat / (s * m) + 4.0 * flat / (c * s * m)
    total = (params + opt_state + ef_rows + cohort + scratch) * lo.safety
    return {
        "params_bcast": params,
        "opt_state_flat": opt_state,
        "ef_rows": ef_rows,
        "cohort_params": cohort,
        "merge_scratch": scratch,
        "total": total,
        "total_gib": total / GIB,
    }


def mesh_state_fits(lo: MeshStateLayout, hbm_bytes: float) -> bool:
    """Whether the estimate fits a per-chip HBM budget (bytes)."""
    return estimate_mesh_state_memory(lo)["total"] <= hbm_bytes


def estimate_round_footprint(lo: MeshStateLayout, *,
                             data_bytes: float = 0.0,
                             cohort_bytes: float = 0.0,
                             members: int = 1,
                             rounds_fused: int = 1) -> Dict[str, float]:
    """Per-chip upper bound for ONE federated round (the JAX package
    holds it against a compiled round's argument+temp footprint).

    ``estimate_mesh_state_memory`` prices the persistent state plane;
    a round additionally holds its *data plane* (device-resident
    dataset + staged cohort index/mask/weight tensors — ``data_bytes``,
    exact per-chip bytes of the staged inputs) and the round's
    working set, modeled as 3x the gathered cohort tensors
    (``cohort_bytes``: forward batch + label pair per resident client) —
    forward residuals, gradients, and the gather scratch of the vmapped
    local step.  ``members`` scales the state/work planes for a
    population-vmapped program (the data plane is shared).

    ``rounds_fused > 1`` (a ``round_block``) additionally prices one
    gathered cohort per fused round: a block stages every round's cohort
    tensors at once (~K cohorts, not 1).  Errs high by the layout's
    ``safety`` like every estimate here."""
    st = estimate_mesh_state_memory(lo)
    k = max(1, int(rounds_fused))
    work = (2.0 + float(k)) * float(cohort_bytes) * lo.safety
    members = max(1, int(members))
    total = members * (st["total"] + work) + float(data_bytes)
    return {
        "state": st["total"],
        "round_work": work,
        "data_plane": float(data_bytes),
        "members": members,
        "total": total,
        "total_gib": total / GIB,
    }


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


def largest_runnable_params(hbm_bytes: float, mesh_shape: tuple,
                            candidates, **layout_kw) -> float:
    """Largest ``n_params`` among ``candidates`` whose per-chip estimate
    fits ``hbm_bytes`` on ``mesh_shape`` (0.0 when nothing fits)."""
    best = 0.0
    for n in sorted(float(n) for n in candidates):
        if mesh_state_fits(MeshStateLayout(n_params=n,
                                           mesh_shape=tuple(mesh_shape),
                                           **layout_kw), hbm_bytes):
            best = n
    return best
