"""Llama-family causal LM in PyTorch (port of ``fedml_tpu.llm.model``: the
training path and the KV-cached decode paths of serving; no ring attention).

RMSNorm, interleaved-pair rotary embeddings, grouped-query attention through
:func:`fedml_tpu_torch.ops.attention.flash_attention` (or the plain
``blockwise_attention``), a SwiGLU MLP or a top-k routed mixture of SwiGLU
experts (:mod:`.moe`).  Weights
keep the flax layout — kernels ``(in, out)``, applied as ``x @ W`` — and the
module tree keeps the flax names, so ``named_parameters()`` gives the flax
paths with ``.`` for ``/`` (``llm/convert.py`` relies on it).

LoRA adapters are not module state: ``forward(tokens, lora)`` takes a flat
``{"layer_0/attention/wq/A": tensor, ...}`` dict, so one frozen base serves
every client of a cohort and per-client state is the adapter dict only.
An adapter pair of rank 3 (``A (B, in, r)``, ``B (B, r, out)``, one per
batch row) is applied as two batched products.  With ``lora_rank == 0`` the
projections are plain ``Dense`` layers (flax names ``wq/kernel``).  The
base is frozen unless the model is built ``trainable`` (dense fine-tuning,
the model hub).

``remat`` picks what the training forward keeps: "full" recomputes each
block in backward, "dots" keeps the outputs of the 2-D matrix products
(``aten.mm``: the projections, the router, the adapters) and recomputes the
rest (attention, the batched expert products, the elementwise ops), as
JAX's ``dots_with_no_batch_dims_saveable`` does; "none" keeps everything.
Both recomputing modes use ``torch.utils.checkpoint``, which
``torch.func``'s transforms refuse: the model hub's models run "none".

``forward(..., decode=True, cache=...)`` is serving's decode path: the new
tokens' K/V are written into a :class:`KVCache` (made by
:meth:`LlamaLM.init_cache`, mutated in place) and attention is computed
against it in plain PyTorch, as the JAX package computes it outside any
Pallas kernel: a dense per-row cache of ``max_seq_len`` positions, or, with
``block_tables``, a page pool shared by every row.  Either may hold int8 rows
with one f32 scale per (row or page, head, position).  The scores are f32
products of the bf16 (or int8) inputs, the probabilities times V a bf16
product accumulated in f32 and cast once, as the JAX einsums with
``preferred_element_type=f32`` compute them.

``LlamaLM(cfg, mesh=...)`` is the tensor-parallel model of one rank of a
``client × model`` mesh (``core/mesh.py``): Megatron's column and row
splits, PyTorch's idiom for what the JAX package's GSPMD ``model`` axis
does with :func:`param_sharding_rules`' specs.  ``wq``/``wk``/``wv``/
``w_gate``/``w_up`` keep their output columns of this rank, ``wo``/
``w_down`` their input rows; the embedding keeps its vocabulary rows and
``lm_head`` its input rows.  A column-parallel layer's input goes through
:func:`copy_to_model` (identity forward, all-reduce backward over the
model group), a row-parallel layer's partial output through
:func:`reduce_from_model` (all-reduce forward, identity backward): the
f/g pair of ``ops/pipeline.py``, so the residual stream is whole and the
same on every rank.  Attention runs
``n_heads/m`` query heads and ``n_kv_heads/m`` KV heads a rank through
the flash kernels (K1–K3) on those local heads; the KV cache holds the
local KV heads.  LoRA adapters stay whole on every rank (their gradients
summed over the model group by the caller); a column-parallel
projection applies its B's columns, a row-parallel one its A's rows.
MoE experts split over the model group (:mod:`.moe`).  With a model
group of one rank the same code runs, its collectives the identity.

``attn_impl="ring"`` with a mesh that has a ``seq`` group
(``make_mesh(seq=n)``) is sequence parallelism: each rank feeds its
``S/n`` token shard and attention runs as ring attention over the group
(``ops/ring_attention.py``, K1–K3 per ring block).  As in the JAX model
inside a ``seq`` shard, positions are ``arange(S_local)`` on every shard:
each shard's RoPE restarts at 0 (a reference quirk, reproduced).

Type promotion follows the flax model exactly: RMSNorm normalises in f32,
casts to the input type, then multiplies by its f32 scale (so in the bf16
config its output is f32, cast back to bf16 by the next projection); LoRA
deltas are computed in f32 and cast to the base output's type; the lm_head
computes in f32 over a kernel stored in the storage type.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..models.base import lecun_normal
from ..ops.attention import blockwise_attention, flash_attention
from ..ops.pipeline import psum_keepgrad, sumgrad
from ..ops.ring_attention import ring_attention
from .moe import MoEMLP

LoRA = Dict[str, torch.Tensor]


class _TP:
    """This rank's place in its model group: ``size`` ranks, index
    ``rank``, collectives over ``mesh``'s ``model`` axis."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.size = int(mesh.model_size)
        self.rank = int(mesh.m_coord)

    def part(self, n: int) -> slice:
        """This rank's contiguous ``1/size`` of ``n`` (divisible)."""
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def copy_to_model(x, tp: Optional[_TP]):
    """Identity forward; the gradient all-reduced over the model group
    (the input of a column-parallel layer): ``ops/pipeline.py::sumgrad``."""
    return x if tp is None else sumgrad(x, tp.mesh, "model")


def reduce_from_model(x, tp: Optional[_TP]):
    """All-reduce over the model group forward (the partial output of a
    row-parallel layer), identity backward:
    ``ops/pipeline.py::psum_keepgrad``."""
    return x if tp is None else psum_keepgrad(x, tp.mesh, "model")


def _tp_rule(role: str, shape, cfg: "LlamaConfig", m: int):
    """The port's sharded dim of a base leaf of full ``shape`` in flax's
    layout over a model group of ``m`` (None: whole), by its role.  JAX's
    rule (:func:`param_sharding_rules`) except where ``TP_DIVERGENCES``
    says why not."""
    if m <= 1 or len(shape) < 2:
        return None
    if role in ("wq", "wo"):
        return 1 if role == "wq" else 0
    if role in ("wk", "wv"):
        return 1 if cfg.n_kv_heads % m == 0 else None
    if role in ("w_gate", "w_up"):
        return 1 if shape[1] % m == 0 else None
    if role == "w_down":
        return 0 if shape[0] % m == 0 else None
    if role in ("tok_embed", "lm_head"):
        return 0 if shape[0] % m == 0 else None
    if role == "expert":
        return 0 if shape[0] % m == 0 else None
    return None                                   # the MoE router


#: leaves whose port spec differs from the JAX package's
#: ``param_sharding_rules``, and why (ROADMAP Queue 3)
TP_DIVERGENCES = {
    "wk/wv": "n_kv_heads % m != 0: replicated, each rank takes the KV "
             "heads of its query heads (JAX splits the columns inside a "
             "head, which the flash kernels cannot read)",
    "tok_embed": "vocab % m != 0: replicated (JAX shards the hidden dim, "
                 "which needs an all-gather a lookup)",
    "lm_head": "dim % m != 0: replicated (JAX shards the vocabulary)",
    "moe_mlp/router": "replicated: every rank routes every token (JAX "
                      "shards its largest divisible dim, resharded at use)",
    "moe_mlp/w_gate,w_up": "experts on dim 0, the expert-parallel split "
                           "(JAX's rule shards dim 1 and _ep_constraint "
                           "reshards to experts at use)",
}


def _role(parts) -> str:
    for r in ("tok_embed", "lm_head"):
        if r in parts:
            return r
    if "moe_mlp" in parts:
        return "router" if "router" in parts else "expert"
    for r in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        if r in parts:
            return r
    return "other"


def param_sharding_rules(params, mesh, cfg: "LlamaConfig") -> Dict[str, tuple]:
    """The model-axis spec of every base leaf (``params``: flat names with
    ``/`` or ``.``, full shapes in flax's layout; tensors or shapes): a
    tuple with ``"model"`` at the sharded dim, ``()`` for whole.  The
    counterpart of ``fedml_tpu/llm/model.py::param_sharding_rules`` and
    what ``LlamaLM(cfg, mesh=mesh)`` builds on each rank."""
    m = int(mesh.shape["model"]) if hasattr(mesh, "shape") else int(mesh)
    out = {}
    for name, leaf in params.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        parts = name.replace(".", "/").split("/")
        d = _tp_rule(_role(parts), shape, cfg, m) if len(shape) >= 2 \
            else None
        if d is None:
            out[name] = ()
        else:
            spec = [None] * len(shape)
            spec[d] = "model"
            out[name] = tuple(spec)
    return out


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    #: storage type of matmul weights and embeddings; None = ``dtype``.
    #: RMSNorm scales stay f32.
    param_dtype: Any = None
    #: auto | flash: the flash kernels; blockwise: the plain streaming
    #: softmax (autograd); ring: the kernels as ring attention over the
    #: mesh's ``seq`` group (``ops/ring_attention.py``; one diagonal K1
    #: call without one)
    attn_impl: str = "auto"
    remat: str = "full"         # full | dots | none
    lora_rank: int = 0
    lora_alpha: float = 16.0
    #: >0 replaces each block's FFN with n_experts top-k routed experts
    n_experts: int = 0
    moe_top_k: int = 2
    #: >0: the federated LoRA round fuses lm_head into a vocab-chunked
    #: cross-entropy (ops/xent.py) instead of materialising the logits
    streaming_xent_chunk: int = 0
    #: decode cache: "native" keeps ``dtype``, "int8" stores K/V rows as
    #: int8 with one f32 scale per (row or page, head, position)
    kv_cache_dtype: str = "native"  # native | int8
    #: >0: the decode cache is one pool of ``kv_pool_pages`` pages of
    #: ``kv_page_tokens`` tokens per layer, addressed through block tables;
    #: page 0 is the trash page (serving/paged_kv.py)
    kv_page_tokens: int = 0
    kv_pool_pages: int = 0

    def __post_init__(self):
        if self.remat not in ("full", "dots", "none"):
            raise ValueError(f"remat={self.remat!r}: must be 'full', "
                             "'dots', or 'none'")
        if self.attn_impl not in ("auto", "blockwise", "flash", "ring"):
            raise ValueError(f"attn_impl={self.attn_impl!r}: must be "
                             "'auto', 'blockwise', 'flash', or 'ring'")
        if self.kv_cache_dtype not in ("native", "int8"):
            raise ValueError(f"kv_cache_dtype={self.kv_cache_dtype!r}: "
                             "must be 'native' or 'int8'")
        if self.kv_page_tokens < 0 or self.kv_pool_pages < 0:
            raise ValueError("kv_page_tokens/kv_pool_pages must be >= 0")
        if (self.kv_pool_pages > 0) != (self.kv_page_tokens > 0):
            raise ValueError(
                "paged KV needs BOTH kv_page_tokens and kv_pool_pages "
                f"(got {self.kv_page_tokens}/{self.kv_pool_pages})")
        if self.kv_pool_pages == 1:
            raise ValueError("kv_pool_pages=1 is only the reserved trash "
                             "page — need at least 2")

    @property
    def store_dtype(self):
        return self.dtype if self.param_dtype is None else self.param_dtype


TINY = LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                   dtype=torch.float32)
LLAMA2_7B = LlamaConfig()


def _rope_tables(positions, d: int, theta: float):
    """cos and sin of the rotary angles for positions ``(S,)`` or ``(B,
    S)``, in f32, shaped to broadcast over x ``(B, H, S, d/2)``."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=positions.device) / d))
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    if positions.dim() == 2:         # (B, S, d/2) -> (B, 1, S, d/2)
        cos, sin = cos[:, None], sin[:, None]
    return cos, sin


def _apply_rope(x, cos, sin):
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


def _rope(x, positions, theta: float):
    """Rotary embedding on x ``(B, H, S, D)``, positions ``(S,)`` shared by
    the batch or ``(B, S)`` per row (the engine's step, every slot at its
    own depth).  Channel pairs are interleaved (``x[..., 0::2]``,
    ``x[..., 1::2]``); angles are f32 and the result is cast back to
    ``x.dtype``."""
    return _apply_rope(x, *_rope_tables(positions, x.shape[-1], theta))


class RMSNorm(nn.Module):
    flax_kinds = {"scale": "scale"}

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim), requires_grad=False)

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        normed = (x.float() * torch.rsqrt(var + self.eps)).to(x.dtype)
        return normed * self.scale


class Dense(nn.Module):
    """``y = x @ kernel`` in ``dtype``; kernel ``(in, out)`` frozen.
    ``lora`` is accepted and unused, so a projection is called the same way
    with or without adapters."""

    flax_kinds = {"kernel": "kernel"}

    def __init__(self, in_features: int, features: int, dtype, param_dtype,
                 take: Optional[slice] = None):
        super().__init__()
        self.dtype = dtype
        #: the input columns this rank multiplies (a row-parallel layer
        #: whose input is whole: ``lm_head``), or None
        self.take = take
        self.kernel = nn.Parameter(
            torch.empty(in_features, features, dtype=param_dtype),
            requires_grad=False)

    def forward(self, x, lora: Optional[LoRA] = None):
        if self.take is not None:
            x = x[..., self.take]
        return x.to(self.dtype) @ self.kernel.to(self.dtype)


class LoRADense(nn.Module):
    """Dense with an optional low-rank adapter read from the ``lora`` dict:
    ``y = x·W + (α/r)·(x·A)·B``, the delta in f32.  ``path`` is the
    module's flax path, set by :class:`LlamaLM`.  Grouped apply: adapters
    with a leading axis aligned with x's batch (``A (B, in, r)``, ``B (B,
    r, out)``) run as two batched products."""

    def __init__(self, in_features: int, features: int, rank: int,
                 alpha: float, dtype, param_dtype,
                 rows: Optional[slice] = None, cols: Optional[slice] = None):
        super().__init__()
        # the adapters' (whole) shapes; the base keeps this rank's part
        self.in_features, self.features = in_features, features
        self.rank, self.alpha = rank, alpha
        #: tensor parallel: the input rows (row-parallel) or output
        #: columns (column-parallel) this rank holds, else None
        self.rows, self.cols = rows, cols
        n_in = in_features if rows is None else rows.stop - rows.start
        n_out = features if cols is None else cols.stop - cols.start
        self.base = Dense(n_in, n_out, dtype, param_dtype)
        self.path = ""

    def forward(self, x, lora: Optional[LoRA] = None):
        y = self.base(x)
        if self.rank > 0 and lora is not None:
            a, b = lora[f"{self.path}/A"], lora[f"{self.path}/B"]
            if self.rows is not None:
                a = a[..., self.rows, :]
            if self.cols is not None:
                b = b[..., self.cols]
            xf = x.float()
            if a.dim() == 3:
                delta = torch.einsum("b...i,bir->b...r", xf, a)
                delta = torch.einsum("b...r,bro->b...o", delta, b)
            else:
                delta = xf @ a @ b
            y = y + (delta * (self.alpha / self.rank)).to(y.dtype)
        return y


class KVCache:
    """The decode cache: per layer a dict of tensors ``k``, ``v`` (and, for
    int8, ``k_scale``, ``v_scale``), in the JAX "cache" collection's shapes.
    Dense: ``(b, h_kv, max_seq_len, d)`` and scales ``(b, h_kv,
    max_seq_len)``; paged: one pool ``(pool_pages, h_kv, page_tokens, d)``
    and scales ``(pool_pages, h_kv, page_tokens)``.  The decode forward
    writes into it in place; :meth:`clone` is a copy that later writes do not
    reach (the prefix caches keep clones)."""

    def __init__(self, layers: List[Dict[str, torch.Tensor]]):
        self.layers = layers

    def clone(self) -> "KVCache":
        return KVCache([{k: t.clone() for k, t in lay.items()}
                        for lay in self.layers])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for lay in self.layers for t in lay.values())

    def rows(self, index) -> "KVCache":
        """The dense cache's rows ``index`` (a slice keeps a view)."""
        return KVCache([{k: t[index] for k, t in lay.items()}
                        for lay in self.layers])

    def copy_rows_(self, index, src: "KVCache") -> None:
        """Write ``src`` into rows ``index`` of this dense cache."""
        for lay, other in zip(self.layers, src.layers):
            for k, t in lay.items():
                t[index] = other[k]


def _acc_f32(a, b):
    """``a @ b`` of the inputs' exact values, accumulated and returned in
    f32 (``einsum(..., preferred_element_type=f32)``).  On the card bf16
    inputs go to cuBLAS with an f32 output (``bmm(out_dtype=f32)``); other
    inputs are upcast, which is exact, and multiplied in f32 (TF32 off on
    the card, ``device.py``)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        lead = a.shape[:-2]
        out = torch.bmm(a.reshape((-1,) + a.shape[-2:]),
                        b.reshape((-1,) + b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.reshape(lead + out.shape[-2:])
    return torch.matmul(a.float(), b.float())


def _quant_rows(x):
    """int8 rows with one f32 scale per row: ``max|x| / 127`` floored at
    1e-8/127, round half to even, clipped to ±127."""
    xf = x.float()
    scale = xf.abs().amax(-1).clamp_min(1e-8) / 127.0
    q8 = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q8, scale


class _DecodeCtx:
    """What every layer of one decode forward shares, computed once: the
    rope tables, where the new rows go and which cache positions each query
    attends.

    Dense (``block_tables`` None): the new rows go at ``start`` (an int, or
    a ``(b,)`` tensor of per-row starts), clamped as
    ``lax.dynamic_update_slice`` clamps a start that would overrun, so an
    overrunning write lands on the last ``s`` positions; rope and the mask
    keep the unclamped positions.  Every query attends to every cache
    position ``<=`` its own.

    Paged: each new row goes to ``pool[table[pos // P], :, pos % P]``, and
    each row reads its whole block-table window (``max_blocks * P``
    positions, the window index being the logical position).  Unallocated
    table entries are 0, the trash page: writes past a row's reservation
    land there, and its reads are always masked."""

    def __init__(self, positions, start, cache: "KVCache", block_tables,
                 cfg: LlamaConfig, b: int, s: int):
        dev = positions.device
        self.cos, self.sin = _rope_tables(positions, cfg.dim // cfg.n_heads,
                                          cfg.rope_theta)
        k0 = cache.layers[0]["k"]
        self.paged = block_tables is not None
        if self.paged:
            ptok = k0.shape[2]
            pos = positions if positions.dim() == 2 else \
                positions[None].expand(b, s)
            self.tables = block_tables.to(dev).long()
            max_blocks = self.tables.shape[1]
            blk = pos // ptok
            self.page = torch.where(
                blk < max_blocks,
                self.tables.gather(1, blk.clamp(max=max_blocks - 1)),
                torch.zeros_like(blk))
            self.offs = pos % ptok
            self.window = max_blocks * ptok
            kv_pos = torch.arange(self.window, device=dev)
            self.mask = (kv_pos <= pos[..., None])[:, None, None]
            return
        length = k0.shape[2]
        if isinstance(start, torch.Tensor):
            st = start.clamp(0, length - s)
            self.idx = st[:, None] + torch.arange(s, device=dev)   # (b, s)
            self.rows = torch.arange(b, device=dev)[:, None]
            self.span = None
        else:
            st = min(max(int(start), 0), length - s)
            self.span = slice(st, st + s)
        kv_pos = torch.arange(length, device=dev)
        mask = kv_pos <= positions[..., None]      # (s, L) or (b, s, L)
        self.mask = mask[None, None, None] if mask.dim() == 2 \
            else mask[:, None, None]

    def write_read(self, att: "Attention", cache, k, v):
        """Write one layer's new rows into its cache; return what that
        layer attends over: ``(k, v, k_scale, v_scale, mask)`` with K/V
        ``(b, h_kv, W, d)`` (scales None unless int8)."""
        kw, vw, ksw, vsw = att._rows_to_store(k, v)
        names = ("k", "v", "k_scale", "v_scale")
        new = (kw, vw, ksw, vsw)
        if self.paged:
            # (b, s, h_kv, ...): the page and offset indices, split by the
            # head slice, go to the front as in numpy
            for name, t in zip(names, new):
                if t is not None:
                    cache[name][self.page, :, self.offs] = t.transpose(1, 2)
            b = k.shape[0]
            window = self.window
            tables = self.tables

            def gather(pool):                    # -> (b, h_kv, W, ...)
                g = pool[tables].movedim(2, 1)   # (b, h_kv, MB, P, ...)
                return g.reshape((b, g.shape[1], window) + g.shape[4:])

            got = [gather(cache[n]) if t is not None else None
                   for n, t in zip(names, new)]
            return (*got, self.mask)
        for name, t in zip(names, new):
            if t is None:
                continue
            if self.span is not None:
                cache[name][:, :, self.span] = t
            else:
                # the target is (b, s, h_kv, ...), as for the pages
                cache[name][self.rows, :, self.idx] = t.transpose(1, 2)
        return (cache["k"], cache["v"], cache.get("k_scale"),
                cache.get("v_scale"), self.mask)


def _kv_heads(cfg: LlamaConfig, tp: Optional[_TP]):
    """``(local query heads, local KV heads, KV heads kept from a whole
    wk/wv or None)`` of one rank.  A TP degree must divide ``n_heads``;
    when it does not divide ``n_kv_heads``, wk/wv stay whole and a rank
    keeps the one KV head its query heads share (``TP_DIVERGENCES``)."""
    m = 1 if tp is None else tp.size
    if cfg.n_heads % m:
        raise NotImplementedError(
            f"a tensor-parallel degree of {m} does not divide n_heads="
            f"{cfg.n_heads}: each rank must hold whole query heads")
    hq = cfg.n_heads // m
    if cfg.n_kv_heads % m == 0:
        return hq, cfg.n_kv_heads // m, None
    rep = cfg.n_heads // cfg.n_kv_heads
    if rep % hq:
        raise NotImplementedError(
            f"a tensor-parallel degree of {m} with n_heads={cfg.n_heads}, "
            f"n_kv_heads={cfg.n_kv_heads}: a rank's query heads would span "
            "part of a KV group")
    kv0 = tp.rank * hq // rep
    return hq, 1, slice(kv0, kv0 + 1)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, tp: Optional[_TP] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        hd = cfg.dim // cfg.n_heads
        self.hq, self.hkv, self.kv_keep = _kv_heads(cfg, tp)
        q_part = None if tp is None else tp.part(cfg.n_heads * hd)
        kv_part = None if tp is None or self.kv_keep is not None else \
            tp.part(cfg.n_kv_heads * hd)
        if cfg.lora_rank > 0:
            mk = lambda i, o, rows=None, cols=None: LoRADense(
                i, o, cfg.lora_rank, cfg.lora_alpha, cfg.dtype,
                cfg.store_dtype, rows=rows, cols=cols)
        else:
            def mk(i, o, rows=None, cols=None):
                n_in = i if rows is None else rows.stop - rows.start
                n_out = o if cols is None else cols.stop - cols.start
                return Dense(n_in, n_out, cfg.dtype, cfg.store_dtype)
        self.wq = mk(cfg.dim, cfg.n_heads * hd, cols=q_part)
        self.wk = mk(cfg.dim, cfg.n_kv_heads * hd, cols=kv_part)
        self.wv = mk(cfg.dim, cfg.n_kv_heads * hd, cols=kv_part)
        self.wo = mk(cfg.n_heads * hd, cfg.dim, rows=q_part)
        if tp is not None:
            self.tp_split = {"wq": 1, "wo": 0}
            if kv_part is not None:
                self.tp_split.update(wk=1, wv=1)

    def forward(self, x, positions, lora: Optional[LoRA] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                ctx: Optional["_DecodeCtx"] = None):
        cfg = self.cfg
        hd = cfg.dim // cfg.n_heads
        b, s, _ = x.shape
        x = copy_to_model(x, self.tp)
        q = self.wq(x, lora).reshape(b, s, self.hq, hd).transpose(1, 2)
        k = self.wk(x, lora).reshape(b, s, -1, hd)
        v = self.wv(x, lora).reshape(b, s, -1, hd)
        if self.kv_keep is not None:
            k, v = k[:, :, self.kv_keep], v[:, :, self.kv_keep]
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        if cache is not None:
            q = _apply_rope(q, ctx.cos, ctx.sin)
            k = _apply_rope(k, ctx.cos, ctx.sin)
            out = self._cached_attend(q, *ctx.write_read(self, cache, k, v))
        else:
            q = _rope(q, positions, cfg.rope_theta)
            k = _rope(k, positions, cfg.rope_theta)
            if cfg.attn_impl == "blockwise":
                out = blockwise_attention(q, k, v, causal=True)
            elif cfg.attn_impl == "ring":
                out = ring_attention(q, k, v,
                                     None if self.tp is None else
                                     self.tp.mesh, causal=True)
            else:
                out = flash_attention(q, k, v, True, None)
        out = out.transpose(1, 2).reshape(b, s, self.hq * hd)
        return reduce_from_model(self.wo(out, lora), self.tp)

    def _rows_to_store(self, k, v):
        """The new rows in the cache's storage: ``(k, v, k_scale, v_scale)``
        (scales None unless int8)."""
        if self.cfg.kv_cache_dtype == "int8":
            k8, ks = _quant_rows(k)
            v8, vs = _quant_rows(v)
            return k8, v8, ks, vs
        return k.to(self.cfg.dtype), v.to(self.cfg.dtype), None, None

    def _cached_attend(self, q, kf, vf, ks, vs, mask):
        """Grouped attention of q ``(b, h, s, d)`` over ``(b, h_kv, W, d)``
        rows, no KV repeat: f32 scores, int8 scales folded into the scores
        and the probabilities, masked positions at -1e30 (exp gives exactly
        0), probabilities cast to the compute type for the P·V product."""
        cfg = self.cfg
        b, h, s, hd = q.shape
        g = kf.shape[1]
        rep = h // g
        width = kf.shape[2]
        qg = q.reshape(b, g, rep * s, hd)
        kc = kf if kf.dtype != torch.int8 else kf.to(q.dtype)
        scores = _acc_f32(qg, kc.transpose(-1, -2)).reshape(
            b, g, rep, s, width)
        if ks is not None:
            scores = scores * ks[:, :, None, None, :]
        scores = scores / (hd ** 0.5)
        scores = torch.where(mask, scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        if vs is not None:
            probs = probs * vs[:, :, None, None, :]
        probs = probs.to(cfg.dtype).reshape(b, g, rep * s, width)
        out = _acc_f32(probs, vf.to(cfg.dtype)).to(cfg.dtype)
        return out.reshape(b, h, s, hd)


class MLP(nn.Module):
    """SwiGLU FFN; tensor-parallel (gate/up by columns, down by rows) when
    the model group divides ``ffn_dim``, else whole on every rank, as the
    JAX rule replicates it."""

    def __init__(self, cfg: LlamaConfig, tp: Optional[_TP] = None):
        super().__init__()
        if tp is not None and cfg.ffn_dim % tp.size:
            tp = None
        self.tp = tp
        ffn = cfg.ffn_dim if tp is None else cfg.ffn_dim // tp.size
        mk = lambda i, o: Dense(i, o, cfg.dtype, cfg.store_dtype)
        self.w_gate = mk(cfg.dim, ffn)
        self.w_up = mk(cfg.dim, ffn)
        self.w_down = mk(ffn, cfg.dim)
        if tp is not None:
            self.tp_split = {"w_gate": 1, "w_up": 1, "w_down": 0}

    def forward(self, x):
        x = copy_to_model(x, self.tp)
        return reduce_from_model(
            self.w_down(F.silu(self.w_gate(x)) * self.w_up(x)), self.tp)


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, tp: Optional[_TP] = None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.attention = Attention(cfg, tp)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        if cfg.n_experts > 0:
            self.moe_mlp = MoEMLP(cfg.dim, cfg.ffn_dim, cfg.n_experts,
                                  cfg.moe_top_k, dtype=cfg.dtype,
                                  param_dtype=cfg.store_dtype,
                                  mesh=None if tp is None else tp.mesh)
        else:
            self.mlp = MLP(cfg, tp)

    def forward(self, x, positions, lora: Optional[LoRA] = None,
                cache=None, ctx=None):
        h = x + self.attention(self.attn_norm(x), positions, lora, cache,
                               ctx)
        ffn = self.moe_mlp if hasattr(self, "moe_mlp") else self.mlp
        return h + ffn(self.mlp_norm(h))


class Embed(nn.Module):
    """Token embedding; over a model group that divides the vocabulary
    each rank holds its rows (a token outside them reads zeros) and the
    group sums the lookups."""

    flax_kinds = {"embedding": "embedding"}

    def __init__(self, vocab: int, dim: int, dtype, param_dtype,
                 tp: Optional[_TP] = None):
        super().__init__()
        if tp is not None and vocab % tp.size:
            tp = None
        self.tp = tp
        self.dtype = dtype
        self.rows = None if tp is None else tp.part(vocab)
        n = vocab if tp is None else vocab // tp.size
        self.embedding = nn.Parameter(
            torch.empty(n, dim, dtype=param_dtype), requires_grad=False)
        if tp is not None:
            self.tp_split = {"embedding": 0}

    def forward(self, tokens):
        if self.tp is None:
            return F.embedding(tokens, self.embedding).to(self.dtype)
        local = tokens - self.rows.start
        n = self.embedding.shape[0]
        own = (local >= 0) & (local < n)
        e = F.embedding(local.clamp(0, n - 1), self.embedding)
        e = torch.where(own[..., None], e, torch.zeros((), dtype=e.dtype,
                                                       device=e.device))
        return reduce_from_model(e, self.tp).to(self.dtype)


def _save_mm_outputs(ctx, op, *args, **kwargs):
    """remat "dots": keep what a 2-D matrix product returns, recompute the
    rest."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_mm_outputs)


class LlamaLM(nn.Module):
    """Submodules carry the flax names: ``tok_embed``, ``layer_{i}``,
    ``final_norm``, ``lm_head``.  The parameters are frozen (gradients flow
    only to the adapter tensors passed in ``lora``) unless ``trainable``.
    ``mesh`` (a ``core.mesh.Mesh``): this rank's tensor-parallel part over
    the mesh's model group (module docstring); its parameters are local
    shards, :meth:`tp_dims` says which dim of each."""

    def __init__(self, cfg: LlamaConfig, trainable: bool = False,
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        tp = None if mesh is None else _TP(mesh)
        self.tp = tp
        self.tok_embed = Embed(cfg.vocab_size, cfg.dim, cfg.dtype,
                               cfg.store_dtype, tp)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", Block(cfg, tp))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        # kernel in the storage type, compute in f32 (logit precision);
        # tensor-parallel: this rank's input rows, the logits summed
        head_tp = tp if tp is not None and cfg.dim % tp.size == 0 else None
        self._head_tp = head_tp
        take = None if head_tp is None else head_tp.part(cfg.dim)
        self.lm_head = Dense(cfg.dim if take is None else
                             cfg.dim // head_tp.size, cfg.vocab_size,
                             torch.float32, cfg.store_dtype, take=take)
        if head_tp is not None:
            self.lm_head.tp_split = {"kernel": 0}
        for name, mod in self.named_modules():
            if isinstance(mod, LoRADense):
                mod.path = name.replace(".", "/")
        self.requires_grad_(trainable)

    def tp_dims(self) -> Dict[str, int]:
        """``{parameter name: dim}`` of every parameter held as this
        rank's model shard (the others are whole); empty without a
        mesh."""
        out = {}
        for mname, mod in self.named_modules():
            for pname, d in getattr(mod, "tp_split", {}).items():
                sub = getattr(mod, pname)
                if isinstance(sub, LoRADense):     # a projection: its kernel
                    pname += ".base.kernel"
                elif isinstance(sub, nn.Module):
                    pname += ".kernel"
                out[f"{mname}.{pname}"] = d
        return out

    def full_shapes(self) -> Dict[str, tuple]:
        """Each parameter's whole shape (its local shape on a mesh, the
        sharded dim times the model group)."""
        dims = self.tp_dims()
        m = 1 if self.tp is None else self.tp.size
        out = {}
        for n, p in self.named_parameters():
            shape = list(p.shape)
            if n in dims:
                shape[dims[n]] *= m
            out[n] = tuple(shape)
        return out

    def lora_shapes(self) -> Dict[str, tuple]:
        """Flat adapter paths → shapes: A ``(in, r)``, B ``(r, out)``."""
        out = {}
        if self.cfg.lora_rank > 0:
            for mod in self.modules():
                if isinstance(mod, LoRADense):
                    out[f"{mod.path}/A"] = (mod.in_features, mod.rank)
                    out[f"{mod.path}/B"] = (mod.rank, mod.features)
        return out

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random base weights from ``generator`` (on the weights' device):
        kernels N(0, 1/fan_in), embeddings N(0, 1/dim), norm scales 1; the
        MoE router and experts lecun-normal as flax draws them (fan_in the
        product of all but the last axis).  On a mesh each leaf is drawn
        whole, one at a time, and this rank keeps its shard, so the
        weights are the unsharded model's."""
        dims = self.tp_dims()
        full = self.full_shapes()
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
                continue
            shape = full[name]
            if ".moe_mlp." in name:
                w = lecun_normal(shape, math.prod(shape[:-1]), generator)
            else:
                fan = shape[0] if name.endswith("kernel") else shape[1]
                w = torch.randn(shape, generator=generator, device=p.device,
                                dtype=torch.float32).mul_(fan ** -0.5)
            if name in dims:
                d = dims[name]
                w = w.narrow(d, self.tp.rank * p.shape[d], p.shape[d])
            p.copy_(w)
            del w

    def init_cache(self, batch: int, device=None, *,
                   page_tokens: Optional[int] = None,
                   pool_pages: Optional[int] = None) -> KVCache:
        """A zeroed decode cache.  Dense, ``batch`` rows of ``max_seq_len``
        positions, unless the config (or ``page_tokens``/``pool_pages``)
        asks for a page pool, which has no batch axis.  In ``dtype`` or
        int8 (``kv_cache_dtype``); on the weights' device by default."""
        cfg = self.cfg
        if device is None:
            device = self.tok_embed.embedding.device
        ptok = cfg.kv_page_tokens if page_tokens is None else page_tokens
        pages = cfg.kv_pool_pages if pool_pages is None else pool_pages
        hd = cfg.dim // cfg.n_heads
        hkv = self.layer_0.attention.hkv if cfg.n_layers else cfg.n_kv_heads
        lead = (pages, hkv, ptok) if ptok > 0 else \
            (batch, hkv, cfg.max_seq_len)
        int8 = cfg.kv_cache_dtype == "int8"
        store = torch.int8 if int8 else cfg.dtype
        layers = []
        for _ in range(cfg.n_layers):
            lay = {"k": torch.zeros(lead + (hd,), dtype=store, device=device),
                   "v": torch.zeros(lead + (hd,), dtype=store, device=device)}
            if int8:
                lay["k_scale"] = torch.zeros(lead, device=device)
                lay["v_scale"] = torch.zeros(lead, device=device)
            layers.append(lay)
        return KVCache(layers)

    def forward(self, tokens, lora: Optional[LoRA] = None, *,
                decode: bool = False, start_pos=None,
                cache: Optional[KVCache] = None, block_tables=None,
                return_hidden: bool = False):
        """Logits ``(..., S, V)`` in f32, or with ``return_hidden`` the
        final-norm hidden states (the streaming cross-entropy applies
        ``lm_head`` itself).

        ``decode=True`` is the KV-cached path: ``cache`` (from
        :meth:`init_cache`) is written in place, and ``start_pos`` gives
        the position of ``tokens[:, 0]``: an int, or a ``(B,)`` tensor of
        per-row depths (the engine's slots).  ``block_tables`` ``(B,
        max_blocks)`` selects the paged pool."""
        if decode and cache is None:
            raise ValueError("decode=True needs a cache (LlamaLM.init_cache)")
        x = self.tok_embed(tokens)
        positions = torch.arange(tokens.shape[-1], device=tokens.device)
        start = 0 if start_pos is None else start_pos
        if isinstance(start, torch.Tensor) and start.dim() == 1:
            start = start.to(tokens.device)
            positions = positions[None, :] + start[:, None]
        elif start_pos is not None:
            if isinstance(start, torch.Tensor):
                start = int(start)
            positions = positions + start
        remat = self.cfg.remat if torch.is_grad_enabled() and not decode \
            else "none"
        ctx = _DecodeCtx(positions, start, cache, block_tables, self.cfg,
                         *tokens.shape[:2]) if decode else None
        for i in range(self.cfg.n_layers):
            block = getattr(self, f"layer_{i}")
            if decode:
                x = block(x, positions, lora, cache.layers[i], ctx)
            elif remat == "full":
                x = checkpoint(block, x, positions, lora, use_reentrant=False)
            elif remat == "dots":
                x = checkpoint(block, x, positions, lora, use_reentrant=False,
                               context_fn=_dots_context)
            else:
                x = block(x, positions, lora)
        x = self.final_norm(x)
        if return_hidden:
            return x
        head_tp = self._head_tp
        return reduce_from_model(self.lm_head(copy_to_model(x, head_tp)),
                                 head_tp)


_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def config_from_args(args, vocab: Optional[int] = None) -> LlamaConfig:
    name = str(getattr(args, "model", "tiny_llama")).lower()
    base = LLAMA2_7B if name in ("llama", "llama2_7b", "llama-2-7b") else TINY
    overrides = {}
    for field in ("dim", "n_layers", "n_heads", "n_kv_heads", "ffn_dim",
                  "max_seq_len"):
        v = getattr(args, f"llm_{field}", None)
        if v is not None:
            overrides[field] = int(v)
    if vocab:
        overrides["vocab_size"] = int(vocab)
    impl = getattr(args, "attn_impl", None)
    if impl:
        overrides["attn_impl"] = str(impl)
    remat = getattr(args, "llm_remat", None)
    if remat:
        overrides["remat"] = str(remat)
    kvd = getattr(args, "llm_kv_cache_dtype", None)
    if kvd:
        overrides["kv_cache_dtype"] = str(kvd)
    dt = getattr(args, "model_dtype", None)
    if dt:
        overrides["dtype"] = _DTYPE_NAMES[str(dt)]
    sx = getattr(args, "streaming_xent_chunk", None)
    if sx is not None:
        overrides["streaming_xent_chunk"] = int(sx)
    n_experts = getattr(args, "n_experts", None)
    if n_experts is not None:
        overrides["n_experts"] = int(n_experts)
        overrides["moe_top_k"] = int(getattr(args, "moe_top_k", 2))
    return dataclasses.replace(base, **overrides)


def build_causal_lm(args, vocab: Optional[int] = None):
    """The model hub's causal LM (names ``transformer``, ``gpt``,
    ``llama``, ``tiny_llama``): a :class:`TorchModel` with task "lm" over
    int32 token windows of ``seq_len`` (default ``min(max_seq_len, 512)``).
    The sp trainers train every parameter, so the weights are f32 masters
    (bf16 storage loses AdamW updates below ~2^-9 relative).  They run
    under ``torch.func``, whose transforms refuse ``torch.utils.
    checkpoint``: the blocks run without recompute (the same numbers, more
    memory), and an ``llm_remat`` other than "none" raises."""
    from ..models.base import TorchModel

    remat = getattr(args, "llm_remat", None)
    if remat and str(remat) != "none":
        raise NotImplementedError(
            f"llm_remat={remat!r} in the model hub: torch.func (the sp "
            "trainers) refuses torch.utils.checkpoint")
    cfg = dataclasses.replace(config_from_args(args, vocab), remat="none")
    if cfg.lora_rank == 0 and cfg.param_dtype is None:
        cfg = dataclasses.replace(cfg, param_dtype=torch.float32)
    seq = int(getattr(args, "seq_len", min(cfg.max_seq_len, 512)))
    with torch.device("meta"):
        module = LlamaLM(cfg, trainable=True)
    return TorchModel(module, (seq,), task="lm", input_dtype=torch.int32)


def causal_nll(logits, targets):
    """Mean token NLL in f32, whatever the compute type."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def per_sequence_loglik(logits, targets):
    """Mean per-sequence token log-likelihood (for masked eval sums)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, targets[..., None])[..., 0].mean(-1)


def masked_nll(model, lora, xb, yb, mb, device):
    """Summed NLL of the batches ``xb``/``yb`` under ``lora``, each
    sequence's mean token NLL weighted by its mask ``mb`` (0 on padding
    rows): ``(nll_sum, count)`` as device tensors."""
    nll = torch.zeros((), device=device)
    cnt = torch.zeros((), device=device)
    for x, y, m in zip(xb, yb, mb):
        m = torch.as_tensor(m, device=device)
        ll = per_sequence_loglik(model(torch.as_tensor(x, device=device),
                                       lora),
                                 torch.as_tensor(y, device=device))
        nll = nll - (ll * m).sum()
        cnt = cnt + m.sum()
    return nll, cnt
