"""Speculative (draft-assisted) greedy decoding (port of
``fedml_tpu.serving.speculative``).

A draft model proposes tokens with cheap cached steps; the target verifies
all of them in ONE multi-token cached forward and accepts the longest
matching prefix plus its own correction token.  The output is the target's
greedy stream token for token: the draft only changes how many target
forwards are spent.  Greedy (temperature 0) only.

Why rejected tokens need no rollback: the decode forward masks every cache
position beyond the query's own (``llm/model.py::_DecodeCtx``), so the K/V
written for rejected draft tokens are never attended until the decode
frontier reaches those positions again, and the block that reaches them
rewrites them first.  Both caches heal this way.  The draft's catch-up
``sync`` block is padded to a fixed ``k + 1`` tokens; the padding's writes
land beyond the last real position and heal by the same argument.

What the argument does not cover is a write that overruns the cache: the
decode forward clamps it (as ``lax.dynamic_update_slice`` does) onto the
last positions, which hold canonical K/V.  So near the end of the buffer,
where the padded sync would overrun, the loop falls back to verify-only
rounds, and the batched engine requires ``max_seq_len >= buf_len + k + 1``
of both models.

``params`` / ``draft_params`` are ``None`` (the model's own weights), a
``{name: tensor}`` dict or an int8 weight-only tree
(:class:`~fedml_tpu_torch.llm.quantization.QuantizedParams`); the draft may
be the target itself under its int8 tree.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .templates.openai_compat import (_apply, _build_cached_decode,
                                      _check_params, _model_device)


def propose_block(model, params, cache, sync, slen, fd, m: int, lora=None):
    """The draft's round: catch-up ``sync`` ``(B, Kpad)`` written at
    positions ``fd..`` (an int, or per-row ``(B,)`` starts), of which the
    first ``slen`` (int or ``(B,)``) tokens are real, then an ``m``-token
    greedy proposal.  Returns ``(d_tokens (B, m), cache)``; ``d_tokens[:,
    j]`` sits at position ``fd + slen + j``.  Shared by
    :func:`speculative_generate` and the batched engine."""
    logits = _apply(model, params, sync, lora, decode=True, start_pos=fd,
                    cache=cache)
    b = sync.shape[0]
    if isinstance(slen, torch.Tensor):
        rows = torch.arange(b, device=logits.device)
        first = logits[rows, slen - 1].argmax(-1)
    else:
        first = logits[:, slen - 1].argmax(-1)
    pos = fd + slen - 1                   # the last canonical position
    toks, tok = [first], first
    for j in range(1, m):
        lg = _apply(model, params, tok[:, None], lora, decode=True,
                    start_pos=pos + j, cache=cache)
        tok = lg[:, 0].argmax(-1)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache


def verify_greedy_block(model, params, cache, block, pos, lora=None):
    """The target's verify: ``block`` ``(B, k)`` written at positions
    ``pos..pos+k-1`` (``pos`` an int or ``(B,)``); returns the target's
    greedy token for each next position ``(B, k)`` and the cache."""
    logits = _apply(model, params, block, lora, decode=True, start_pos=pos,
                    cache=cache)
    return logits.argmax(-1), cache


def speculative_generate(model, params, draft_model, draft_params,
                         prompt_ids: List[int], max_new_tokens: int = 64,
                         buf_len: int = 256, k: int = 4,
                         eos_id: Optional[int] = None,
                         on_token=None, adaptive_k: bool = True,
                         lora=None, draft_lora=None
                         ) -> Tuple[List[int], Dict[str, float]]:
    """Greedy decode of ``max_new_tokens`` with draft-model speculation,
    on the target's device.  Returns ``(tokens, stats)``:
    ``target_forwards`` counts the target's forwards, ``draft_forwards``
    the draft's, ``acceptance_rate`` the share of proposals accepted.

    ``adaptive_k`` (the HF assisted-generation heuristic): the verify block
    starts at 2 tokens (1 proposal + the current token), doubles toward
    ``k`` after a fully accepted round and halves after a rejection.  The
    output does not depend on the schedule.

    ``lora`` applies an adapter (a flat dict) to the target's prefill and
    verify, so the output equals ``generate(..., lora=lora)`` at
    temperature 0; ``draft_lora`` personalizes the draft (only the
    acceptance rate depends on it)."""
    _check_params(params)
    _check_params(draft_params)
    t_prefill, _, _ = _build_cached_decode(model, 0, 1.0)
    d_prefill, _, _ = _build_cached_decode(draft_model, 0, 1.0)
    dev = _model_device(model)
    prompt_ids = list(prompt_ids)[-(buf_len - 1):]
    n = len(prompt_ids)
    buf = torch.zeros((1, buf_len), dtype=torch.long, device=dev)
    buf[0, :n] = torch.tensor(prompt_ids, dtype=torch.long)
    out: List[int] = []
    stats = {"target_forwards": 1, "draft_forwards": 1,
             "proposed": 0, "accepted": 0}

    with torch.no_grad():
        # both models prefill the prompt; the target's greedy next token is
        # the first "cur" (generate()'s prefill token at temperature 0)
        cur, t_cache = t_prefill(params, lora, buf, n, None, 0.0)
        _, d_cache = d_prefill(draft_params, draft_lora, buf, n, None, 0.0)
        pos_holder = [n]
        f_d = n   # the draft's confirmed frontier: < f_d is canonical K/V

        def emit(tok: int) -> bool:
            if eos_id is not None and tok == eos_id:
                return False
            if pos_holder[0] >= buf_len or len(out) >= max_new_tokens:
                return False
            out.append(tok)
            if on_token is not None:
                on_token(tok)
            return len(out) < max_new_tokens

        cur = int(cur)
        if not emit(cur):
            return out, _finalize(stats)

        depth = min(2, k) if adaptive_k else k
        while True:
            pos = pos_holder[0]
            block_k = min(depth, k, buf_len - pos)
            if block_k < 1:
                break
            d_tokens: List[int] = []
            # near the buffer end the fixed (k+1) padded sync would clamp
            # its cache write onto canonical draft K/V below the frontier:
            # verify-only rounds there
            if block_k >= 2 and f_d + k + 1 <= buf_len:
                sync = [(prompt_ids[p] if p < n else out[p - n])
                        for p in range(f_d, pos + 1)]
                assert len(sync) <= k + 1, (len(sync), k)
                sync_buf = torch.zeros((1, k + 1), dtype=torch.long,
                                       device=dev)
                sync_buf[0, :len(sync)] = torch.tensor(sync,
                                                       dtype=torch.long)
                d_dev, d_cache = propose_block(
                    draft_model, draft_params, d_cache, sync_buf, len(sync),
                    f_d, block_k - 1, draft_lora)
                stats["draft_forwards"] += block_k - 1
                f_d = pos + 1
                d_tokens = [int(t) for t in d_dev[0].tolist()]
            stats["proposed"] += len(d_tokens)
            block_k = len(d_tokens) + 1

            block = torch.tensor([[cur] + d_tokens], dtype=torch.long,
                                 device=dev)
            greedy, t_cache = verify_greedy_block(model, params, t_cache,
                                                  block, pos, lora)
            stats["target_forwards"] += 1
            greedy_host = greedy[0].tolist()

            done = rejected = False
            for i, d in enumerate(d_tokens):
                g = int(greedy_host[i])
                if d != g:
                    # first disagreement: the target's own token replaces it
                    rejected = True
                    pos_holder[0] = pos + i + 1
                    cur = g
                    done = not emit(g)
                    break
                stats["accepted"] += 1
                pos_holder[0] = pos + i + 1
                if not emit(d):
                    done = True
                    break
                cur = d
            else:
                # every proposal accepted: the block's last greedy token is
                # the target's continuation of the final draft token
                g = int(greedy_host[block_k - 1])
                pos_holder[0] = pos + block_k
                cur = g
                done = not emit(g)
            if done:
                break
            if adaptive_k:
                depth = max(2, depth // 2) if rejected else \
                    (depth * 2 if depth < k else depth)
    return out, _finalize(stats)


def _finalize(stats: Dict[str, int]) -> Dict[str, float]:
    stats = dict(stats)
    stats["acceptance_rate"] = (stats["accepted"] / stats["proposed"]
                                if stats["proposed"] else 0.0)
    return stats


def sync_rows(hist: List[int], fd: int, pos: int, kp1: int) -> np.ndarray:
    """The draft's catch-up tokens ``hist[fd:pos+1]`` padded to ``kp1``."""
    sync = hist[fd:pos + 1]
    assert 1 <= len(sync) <= kp1, (len(sync), kp1)
    row = np.zeros(kp1, np.int64)
    row[:len(sync)] = sync
    return row


__all__ = ["propose_block", "speculative_generate", "verify_greedy_block"]
