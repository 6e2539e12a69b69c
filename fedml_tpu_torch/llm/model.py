"""Llama-family causal LM in PyTorch (port of ``fedml_tpu.llm.model``, the
training path: no decode, paged-cache, MoE or ring-attention code).

RMSNorm, interleaved-pair rotary embeddings, grouped-query attention through
:func:`fedml_tpu_torch.ops.attention.flash_attention`, SwiGLU MLP.  Weights
keep the flax layout — kernels ``(in, out)``, applied as ``x @ W`` — and the
module tree keeps the flax names, so ``named_parameters()`` gives the flax
paths with ``.`` for ``/`` (``llm/convert.py`` relies on it).

LoRA adapters are not module state: ``forward(tokens, lora)`` takes a flat
``{"layer_0/attention/wq/A": tensor, ...}`` dict, so one frozen base serves
every client of a cohort and per-client state is the adapter dict only.

Type promotion follows the flax model exactly: RMSNorm normalises in f32,
casts to the input type, then multiplies by its f32 scale (so in the bf16
config its output is f32, cast back to bf16 by the next projection); LoRA
deltas are computed in f32 and cast to the base output's type; the lm_head
computes in f32 over a kernel stored in the storage type.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import flash_attention

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
    attn_impl: str = "auto"     # auto | flash: both are the flash kernels
    #: "full" recomputes each block in backward (torch.utils.checkpoint),
    #: "none" keeps every activation
    remat: str = "full"         # full | none
    lora_rank: int = 0
    lora_alpha: float = 16.0

    def __post_init__(self):
        if self.remat not in ("full", "none"):
            raise ValueError(f"remat={self.remat!r}: the port has 'full' and "
                             "'none'")
        if self.attn_impl not in ("auto", "flash"):
            raise ValueError(f"attn_impl={self.attn_impl!r}: the port has "
                             "'auto' and 'flash'")

    @property
    def store_dtype(self):
        return self.dtype if self.param_dtype is None else self.param_dtype


TINY = LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                   n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                   dtype=torch.float32)
LLAMA2_7B = LlamaConfig()


def _rope(x, positions, theta: float):
    """Rotary embedding on x ``(B, H, S, D)``, positions ``(S,)``.  Channel
    pairs are interleaved (``x[..., 0::2]``, ``x[..., 1::2]``); angles are
    f32 and the result is cast back to ``x.dtype``."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim), requires_grad=False)

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        normed = (x.float() * torch.rsqrt(var + self.eps)).to(x.dtype)
        return normed * self.scale


class Dense(nn.Module):
    """``y = x @ kernel`` in ``dtype``; kernel ``(in, out)`` frozen."""

    def __init__(self, in_features: int, features: int, dtype, param_dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(
            torch.empty(in_features, features, dtype=param_dtype),
            requires_grad=False)

    def forward(self, x):
        return x.to(self.dtype) @ self.kernel.to(self.dtype)


class LoRADense(nn.Module):
    """Dense with an optional low-rank adapter read from the ``lora`` dict:
    ``y = x·W + (α/r)·(x·A)·B``, the delta in f32.  ``path`` is the
    module's flax path, set by :class:`LlamaLM`."""

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
            delta = x.float() @ a @ b
            y = y + (delta * (self.alpha / self.rank)).to(y.dtype)
        return y


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.dim // cfg.n_heads
        mk = lambda i, o: LoRADense(i, o, cfg.lora_rank, cfg.lora_alpha,
                                    cfg.dtype, cfg.store_dtype)
        self.wq = mk(cfg.dim, cfg.n_heads * hd)
        self.wk = mk(cfg.dim, cfg.n_kv_heads * hd)
        self.wv = mk(cfg.dim, cfg.n_kv_heads * hd)
        self.wo = mk(cfg.n_heads * hd, cfg.dim)

    def forward(self, x, positions, lora: Optional[LoRA] = None):
        cfg = self.cfg
        hd = cfg.dim // cfg.n_heads
        b, s, _ = x.shape
        q = self.wq(x, lora).reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
        k = self.wk(x, lora).reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
        v = self.wv(x, lora).reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        out = flash_attention(q, k, v, True, None)
        out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * hd)
        return self.wo(out, lora)


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
        self.mlp = MLP(cfg)

    def forward(self, x, positions, lora: Optional[LoRA] = None):
        h = x + self.attention(self.attn_norm(x), positions, lora)
        return h + self.mlp(self.mlp_norm(h))


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, dtype, param_dtype):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(
            torch.empty(vocab, dim, dtype=param_dtype), requires_grad=False)

    def forward(self, tokens):
        return F.embedding(tokens, self.embedding).to(self.dtype)


class LlamaLM(nn.Module):
    """Submodules carry the flax names: ``tok_embed``, ``layer_{i}``,
    ``final_norm``, ``lm_head``.  Every parameter is frozen; gradients flow
    only to the adapter tensors passed in ``lora``."""

    def __init__(self, cfg: LlamaConfig):
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
        kernels N(0, 1/fan_in), embeddings N(0, 1/dim), norm scales 1."""
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
                continue
            fan = p.shape[0] if name.endswith("kernel") else p.shape[1]
            w = torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32)
            p.copy_(w.mul_(fan ** -0.5))

    def forward(self, tokens, lora: Optional[LoRA] = None):
        x = self.tok_embed(tokens)
        positions = torch.arange(tokens.shape[-1], device=tokens.device)
        remat = self.cfg.remat == "full" and torch.is_grad_enabled()
        for i in range(self.cfg.n_layers):
            block = getattr(self, f"layer_{i}")
            if remat:
                x = checkpoint(block, x, positions, lora, use_reentrant=False)
            else:
                x = block(x, positions, lora)
        return self.lm_head(self.final_norm(x))


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
    dt = getattr(args, "model_dtype", None)
    if dt:
        overrides["dtype"] = _DTYPE_NAMES[str(dt)]
    return dataclasses.replace(base, **overrides)


def causal_nll(logits, targets):
    """Mean token NLL in f32, whatever the compute type."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def per_sequence_loglik(logits, targets):
    """Mean per-sequence token log-likelihood (for masked eval sums)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, targets[..., None])[..., 0].mean(-1)
