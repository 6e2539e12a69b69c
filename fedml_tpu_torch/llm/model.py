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
from .moe import MoEMLP

LoRA = Dict[str, torch.Tensor]


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
    #: softmax (autograd); ring: over the mesh (not ported, refused)
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
        if self.attn_impl == "ring":
            raise NotImplementedError(
                "attn_impl='ring': ring attention over the mesh is not "
                "ported yet")
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

    def __init__(self, in_features: int, features: int, dtype, param_dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(in_features, features, dtype=param_dtype),
            requires_grad=False)

    def forward(self, x, lora: Optional[LoRA] = None):
        return x.to(self.dtype) @ self.kernel.to(self.dtype)


class LoRADense(nn.Module):
    """Dense with an optional low-rank adapter read from the ``lora`` dict:
    ``y = x·W + (α/r)·(x·A)·B``, the delta in f32.  ``path`` is the
    module's flax path, set by :class:`LlamaLM`.  Grouped apply: adapters
    with a leading axis aligned with x's batch (``A (B, in, r)``, ``B (B,
    r, out)``) run as two batched products."""

    def __init__(self, in_features: int, features: int, rank: int,
                 alpha: float, dtype, param_dtype):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.rank, self.alpha = rank, alpha
        self.base = Dense(in_features, features, dtype, param_dtype)
        self.path = ""

    def forward(self, x, lora: Optional[LoRA] = None):
        y = self.base(x)
        if self.rank > 0 and lora is not None:
            a, b = lora[f"{self.path}/A"], lora[f"{self.path}/B"]
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


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.dim // cfg.n_heads
        if cfg.lora_rank > 0:
            mk = lambda i, o: LoRADense(i, o, cfg.lora_rank, cfg.lora_alpha,
                                        cfg.dtype, cfg.store_dtype)
        else:
            mk = lambda i, o: Dense(i, o, cfg.dtype, cfg.store_dtype)
        self.wq = mk(cfg.dim, cfg.n_heads * hd)
        self.wk = mk(cfg.dim, cfg.n_kv_heads * hd)
        self.wv = mk(cfg.dim, cfg.n_kv_heads * hd)
        self.wo = mk(cfg.n_heads * hd, cfg.dim)

    def forward(self, x, positions, lora: Optional[LoRA] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                ctx: Optional["_DecodeCtx"] = None):
        cfg = self.cfg
        hd = cfg.dim // cfg.n_heads
        b, s, _ = x.shape
        q = self.wq(x, lora).reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
        k = self.wk(x, lora).reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
        v = self.wv(x, lora).reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
        if cache is not None:
            q = _apply_rope(q, ctx.cos, ctx.sin)
            k = _apply_rope(k, ctx.cos, ctx.sin)
            out = self._cached_attend(q, *ctx.write_read(self, cache, k, v))
        else:
            q = _rope(q, positions, cfg.rope_theta)
            k = _rope(k, positions, cfg.rope_theta)
            if cfg.attn_impl == "blockwise":
                out = blockwise_attention(q, k, v, causal=True)
            else:
                out = flash_attention(q, k, v, True, None)
        out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
        return self.wo(out, lora)

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
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        mk = lambda i, o: Dense(i, o, cfg.dtype, cfg.store_dtype)
        self.w_gate = mk(cfg.dim, cfg.ffn_dim)
        self.w_up = mk(cfg.dim, cfg.ffn_dim)
        self.w_down = mk(cfg.ffn_dim, cfg.dim)

    def forward(self, x):
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.attention = Attention(cfg)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        if cfg.n_experts > 0:
            self.moe_mlp = MoEMLP(cfg.dim, cfg.ffn_dim, cfg.n_experts,
                                  cfg.moe_top_k, dtype=cfg.dtype,
                                  param_dtype=cfg.store_dtype)
        else:
            self.mlp = MLP(cfg)

    def forward(self, x, positions, lora: Optional[LoRA] = None,
                cache=None, ctx=None):
        h = x + self.attention(self.attn_norm(x), positions, lora, cache,
                               ctx)
        ffn = self.moe_mlp if hasattr(self, "moe_mlp") else self.mlp
        return h + ffn(self.mlp_norm(h))


class Embed(nn.Module):
    flax_kinds = {"embedding": "embedding"}

    def __init__(self, vocab: int, dim: int, dtype, param_dtype):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(
            torch.empty(vocab, dim, dtype=param_dtype), requires_grad=False)

    def forward(self, tokens):
        return F.embedding(tokens, self.embedding).to(self.dtype)


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
    only to the adapter tensors passed in ``lora``) unless ``trainable``."""

    def __init__(self, cfg: LlamaConfig, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = Embed(cfg.vocab_size, cfg.dim, cfg.dtype,
                               cfg.store_dtype)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", Block(cfg))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps)
        # kernel in the storage type, compute in f32 (logit precision)
        self.lm_head = Dense(cfg.dim, cfg.vocab_size, torch.float32,
                             cfg.store_dtype)
        for name, mod in self.named_modules():
            if isinstance(mod, LoRADense):
                mod.path = name.replace(".", "/")
        self.requires_grad_(trainable)

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
        product of all but the last axis)."""
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
                continue
            if ".moe_mlp." in name:
                p.copy_(lecun_normal(p.shape, math.prod(p.shape[:-1]),
                                     generator))
                continue
            fan = p.shape[0] if name.endswith("kernel") else p.shape[1]
            w = torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32)
            p.copy_(w.mul_(fan ** -0.5))

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
        lead = (pages, cfg.n_kv_heads, ptok) if ptok > 0 else \
            (batch, cfg.n_kv_heads, cfg.max_seq_len)
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
        return self.lm_head(x)


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
