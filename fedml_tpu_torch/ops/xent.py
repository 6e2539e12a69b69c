"""Streaming (vocab-chunked) softmax cross-entropy (port of
``fedml_tpu.ops.xent.streaming_xent``).

The head product and the loss are fused: the logits are made one vocab
chunk at a time (running max, running sum of exponentials and the target
logit, all f32), so the forward never holds the ``(N, V)`` logit tensor,
and the backward recomputes each chunk's logits instead of keeping them.
The vocabulary is padded up to a chunk multiple; the padded columns' logits
are set to ``-1e30`` and drop out of the softmax statistics.

Every chunk product runs in f32 (both operands upcast, TF32 off as
:mod:`..device` sets it): a bf16 product in torch returns bf16, where the
JAX package asks for f32 accumulation (``preferred_element_type``) — the
logits would lose 8 bits.  The products stay ``torch.matmul``: the JAX
package computes them in XLA, not in a kernel of its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _chunk_logits(h2f, w, base: int, chunk: int):
    """f32 logits of the columns ``[base, base + chunk)`` of ``w``, the
    columns past the vocabulary set to ``-1e30``; and the chunk's weight
    (zero-padded to ``chunk`` columns) in f32."""
    v = w.shape[1]
    wc = w[:, base:base + chunk].float()
    if wc.shape[1] < chunk:
        wc = F.pad(wc, (0, chunk - wc.shape[1]))
    logits = h2f @ wc
    if base + chunk > v:
        col = base + torch.arange(chunk, device=w.device)
        logits = torch.where(col[None, :] < v, logits, NEG_INF)
    return logits, wc


class _StreamingXent(torch.autograd.Function):
    """(mean NLL, per-token lse); the lse is not differentiable."""

    @staticmethod
    def forward(h, w, targets, chunk):
        d, v = w.shape
        h2f = h.reshape(-1, d).float()
        t2 = targets.reshape(-1)
        n = h2f.shape[0]
        m = torch.full((n,), float("-inf"), device=h.device)
        s = torch.zeros((n,), device=h.device)
        tl = torch.zeros((n,), device=h.device)
        for base in range(0, v, chunk):
            logits, _ = _chunk_logits(h2f, w, base, chunk)
            m_c = logits.amax(-1)
            s_c = torch.exp(logits - m_c[:, None]).sum(-1)
            idx = t2 - base
            in_chunk = (idx >= 0) & (idx < chunk)
            tgt = logits.gather(1, idx.clamp(0, chunk - 1)[:, None])[:, 0]
            tl = tl + torch.where(in_chunk, tgt, 0.0)
            m_new = torch.maximum(m, m_c)
            s = s * torch.exp(m - m_new) + s_c * torch.exp(m_c - m_new)
            m = m_new
        lse = m + torch.log(s)
        return (lse - tl).mean(), lse.reshape(targets.shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, w, targets, chunk = inputs
        ctx.save_for_backward(h, w, targets, output[1])
        ctx.chunk = chunk
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, g, _dlse):
        h, w, targets, lse = ctx.saved_tensors
        chunk = ctx.chunk
        d, v = w.shape
        h2f = h.reshape(-1, d).float()
        t2 = targets.reshape(-1)
        lse2 = lse.reshape(-1)
        n = h2f.shape[0]
        scale = g / n                       # d(mean)/d(per-token terms)
        need_dw = ctx.needs_input_grad[1]
        dh = torch.zeros((n, d), device=h.device)
        # each column block of dw is one chunk's product: cast as it lands
        dw = torch.empty((d, v), dtype=w.dtype, device=w.device) \
            if need_dw else None
        for base in range(0, v, chunk):
            logits, wc = _chunk_logits(h2f, w, base, chunk)
            col = base + torch.arange(chunk, device=h.device)
            p = torch.exp(logits - lse2[:, None])     # padded columns: 0
            onehot = (t2[:, None] == col[None, :]).float()
            dlogits = (p - onehot) * scale
            dh = dh + dlogits @ wc.T
            if need_dw:
                width = min(chunk, v - base)
                dw[:, base:base + width] = (h2f.T @ dlogits)[:, :width]
        return dh.reshape(h.shape).to(h.dtype), dw, None, None


def streaming_xent(h, w, targets, chunk: int = 4096) -> torch.Tensor:
    """Mean token NLL of ``softmax(h @ w)`` against ``targets`` without the
    full logit tensor.  ``h (..., D)`` hidden states, ``w (D, V)`` the head
    (no bias), ``targets (...)`` int labels in ``[0, V)``.  The gradient of
    ``w`` is computed only when ``w`` requires one (the LoRA paths freeze
    ``lm_head``)."""
    return _StreamingXent.apply(h, w, targets, int(chunk))[0]
