"""Transformer text classifier, the FedNLP workload (port of
``fedml_tpu.models.text_transformer``).

Token ids ``(B, S)`` int32, 0 = padding → class logits ``(B, C)``: token
and learned position embeddings, ``n_layers`` pre-norm encoder blocks
whose attention is :func:`~fedml_tpu_torch.ops.attention.flash_attention`
run non-causally (K1 forward, K2 and K3 backward on the card; their plain
versions on the CPU), a final LayerNorm, masked-mean pooling and an f32
classifier.  The JAX module's semantics are kept exactly:

- flax's LayerNorm epsilon 1e-6 and its tanh-approximated ``gelu``;
- Q, K, V and O projections without bias, FFN layers with bias;
- pad keys and values are zeroed, not masked: they still add a uniform
  term to the softmax denominator, as in the JAX model;
- the attention output and the FFN output are multiplied by the pad
  mask; pooling divides by ``max(count, 1)``.

Parameter names are flax's (``tok_embed.weight`` ↔ ``tok_embed/embedding``,
``layer_0.wq.weight`` ↔ ``layer_0/wq/kernel``, ``pos_embed``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention

LN_EPS = 1e-6   # flax nn.LayerNorm's default


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, ffn_dim: int):
        super().__init__()
        self.n_heads = n_heads
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=LN_EPS)
        self.wq = nn.Linear(dim, dim, bias=False)
        self.wk = nn.Linear(dim, dim, bias=False)
        self.wv = nn.Linear(dim, dim, bias=False)
        self.wo = nn.Linear(dim, dim, bias=False)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff_up = nn.Linear(dim, ffn_dim)
        self.ff_down = nn.Linear(ffn_dim, dim)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor
                ) -> torch.Tensor:
        h = self.LayerNorm_0(x)
        b, s, dim = h.shape
        heads = lambda t: t.reshape(b, s, self.n_heads, -1).transpose(1, 2)
        key_mask = pad_mask[:, :, None]
        q = heads(self.wq(h))
        k = heads(self.wk(h) * key_mask)
        v = heads(self.wv(h) * key_mask)
        att = flash_attention(q, k, v, causal=False)
        att = att.transpose(1, 2).reshape(b, s, dim)
        x = x + self.wo(att) * key_mask
        ff = self.ff_down(F.gelu(self.ff_up(self.LayerNorm_1(x)),
                                 approximate="tanh"))
        return x + ff * key_mask


class TextTransformerClassifier(nn.Module):
    #: std of the bare parameters' normal initialisers (flax's
    #: ``normal(0.02)`` for the position table)
    normal_init_std = {"pos_embed": 0.02}

    def __init__(self, vocab_size: int, num_classes: int, dim: int = 256,
                 n_layers: int = 4, n_heads: int = 8, ffn_dim: int = 512,
                 max_len: int = 512):
        super().__init__()
        self.n_layers = n_layers
        self.tok_embed = nn.Embedding(vocab_size, dim)
        self.pos_embed = nn.Parameter(torch.empty(max_len, dim))
        for i in range(n_layers):
            setattr(self, f"layer_{i}", EncoderBlock(dim, n_heads, ffn_dim))
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=LN_EPS)
        self.classifier = nn.Linear(dim, num_classes)

    def forward(self, tokens: torch.Tensor, dropout_masks=None
                ) -> torch.Tensor:
        pad_mask = (tokens > 0).to(torch.float32)
        x = self.tok_embed(tokens) + self.pos_embed[:tokens.shape[1]][None]
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, pad_mask)
        x = self.LayerNorm_0(x)
        denom = torch.clamp_min(pad_mask.sum(-1, keepdim=True), 1.0)
        pooled = (x * pad_mask[:, :, None]).sum(1) / denom
        return self.classifier(pooled)
