"""OpenAI-compatible chat/completions endpoint over a causal LM (port of
``fedml_tpu.serving.templates.openai_compat``).

- **KV-cached decode.**  Given a model with a decode path
  (``llm.model.LlamaLM``), generation is one prefill over the padded prompt
  buffer, then single-token steps against a ``max_seq_len`` KV cache
  (:class:`~fedml_tpu_torch.llm.model.KVCache`, written in place).
- **Fixed-shape fallback.**  Any bare ``apply_fn(params, tokens) -> logits``
  still works: the token buffer is padded to ``buf_len`` and each step
  re-runs the full forward.
- **Sampling.**  One ``torch.Generator`` per request, seeded from the
  request's seed; temperature 0 is argmax.  A sampled token is the argmax of
  ``logits / temp`` plus Gumbel noise drawn from that generator (the draws
  are not JAX's threefry ones, so a seed gives other samples than the JAX
  package; inside the port, :func:`generate` and the batching engine draw
  the same sequence for a request).
- **Weights.**  ``params`` is ``None`` (the model's own weights), a
  ``{name: tensor}`` dict with ``named_parameters()`` names, applied through
  ``torch.func.functional_call``, or an int8 weight-only tree of
  ``llm/quantization.py`` (each weight dequantized at the product that
  consumes it); the prefix caches key their entries on its identity, so a
  swapped tree never meets KV computed under the old one.
- **Speculative decode.**  With ``draft_model``/``draft_params`` greedy
  requests run ``serving/speculative.py`` (or its batching engine), with
  the same output as plain greedy decode.
- **No extra dependencies.**  The stdlib HTTP server, bound to loopback by
  default, and a byte-level tokenizer unless one is given.
- **Observability.**  ``slo_rules`` ride into the batching engine;
  ``metrics_port`` serves ``/metrics`` and ``/healthz`` beside the API
  (with the engine's request histograms and objective windows); a valid
  W3C ``traceparent`` header joins a request's span tree to the caller's
  trace, and the fall-through path and streams emit their own
  ``serve.request`` and ``serve.stream`` spans.
"""

from __future__ import annotations

import collections
import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Mapping, Optional

import torch

from ...llm.quantization import QuantizedParams, weight_dtype
from ...obs.context import parse_traceparent
from ...obs.tracer import get_tracer

log = logging.getLogger(__name__)

#: fixed width of the one-call tail-replay block: a partial prefix hit with
#: an uncached tail up to this long replays as one forward instead of
#: per-token steps
TAIL_BLOCK = 32


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0..255 = bytes, 256 = BOS, 257 = EOS."""

    vocab_size = 258
    bos_id = 256
    eos_id = 257

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] if add_bos else []) + ids

    def decode(self, ids) -> str:
        data = bytes(i for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace")


def _check_params(params) -> None:
    """Refuse a weight tree the port does not run: anything but ``None``,
    a ``{name: float tensor}`` dict, or an int8 weight-only tree of
    :func:`~fedml_tpu_torch.llm.quantization.quantize_params_int8` (a
    :class:`~fedml_tpu_torch.llm.quantization.QuantizedParams`)."""
    if params is None:
        return
    if not isinstance(params, Mapping):
        raise TypeError("params must be None (the model's own weights), a "
                        "{name: tensor} dict or a QuantizedParams tree")
    if isinstance(params, QuantizedParams):
        params.check()
        return
    for name, t in params.items():
        if "__q8__" in str(name) or not isinstance(t, torch.Tensor) \
                or not t.is_floating_point():
            raise TypeError(
                f"params[{name!r}]: not a float tensor; an int8 weight-only "
                "tree must be the QuantizedParams of "
                "llm/quantization.py::quantize_params_int8")


def _apply(model, params, *args, **kw):
    """``model(*args, **kw)`` with ``params`` (None: its own weights; a
    quantized tree dequantizes each weight at its consuming product)."""
    if params is None:
        return model(*args, **kw)
    if isinstance(params, QuantizedParams):
        params = params.lazy(weight_dtype(model))
    return torch.func.functional_call(model, params, args, kw)


def _model_device(model, device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if model is not None:
        return next(model.parameters()).device
    return torch.device("cuda")


def _filter(live, top_k: int, top_p: float):
    """Top-k then nucleus top-p on logits ``(..., V)``: top-k keeps the k
    highest, top-p the smallest prefix of the sorted distribution whose
    mass before each kept token is below p (the argmax always stays);
    everything below the smallest kept value becomes -inf."""
    if not ((top_k and top_k > 0) or top_p < 1.0):
        return live
    inf = torch.tensor(float("inf"), device=live.device)
    sd = torch.sort(live, dim=-1, descending=True).values
    if top_k and top_k > 0:
        idx = torch.arange(sd.shape[-1], device=live.device)
        sd = torch.where(idx < top_k, sd, -inf)
    if top_p < 1.0:
        probs = torch.softmax(sd, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        keep[..., 0] = True
        sd = torch.where(keep, sd, -inf)
    kth = torch.where(torch.isfinite(sd), sd, inf).amin(-1, keepdim=True)
    return torch.where(live < kth, -inf, live)


def _sample_rows(logits, gens, temps, top_k: int, top_p: float):
    """Logits ``(b, V)`` -> ``(b,)`` token ids on the device, row i greedy
    at ``temps[i] == 0``, else drawn from ``gens[i]`` (Gumbel-max over
    ``logits / temp`` after the filters).  ``temps`` are host floats, so
    choosing the rows costs no device read."""
    live = _filter(logits.float(), top_k, top_p)
    tok = live.argmax(-1)
    tiny = torch.finfo(torch.float32).tiny
    for i, (gen, temp) in enumerate(zip(gens, temps)):
        if temp > 0 and gen is not None:
            u = torch.rand(live.shape[-1], generator=gen,
                           device=live.device).clamp_min(tiny)
            tok[i] = (live[i] / max(temp, 1e-6)
                      - torch.log(-torch.log(u))).argmax()
    return tok


def _sample_live(live, gen, temp: float, top_k: int, top_p: float = 1.0):
    """live: ``(V,)`` logits -> sampled token id (0-d tensor; greedy at
    temp 0)."""
    return _sample_rows(live[None], [gen], [float(temp)], top_k, top_p)[0]


def _plain_step(apply_fn, params, buf, pos, gen, temp, top_k, top_p):
    """Full-buffer step: the logits at ``pos - 1`` predict token ``pos``."""
    logits = apply_fn(params, buf)                    # (1, L, V)
    return _sample_live(logits[0, pos - 1], gen, temp, top_k, top_p)


def _token(t, device):
    return torch.tensor([[int(t)]], dtype=torch.long, device=device)


def _build_cached_decode(model, top_k: int, top_p: float):
    """``(prefill, step, tail_block)`` over a model with a decode path; each
    takes ``(params, lora, ...)``, ``lora`` a flat adapter dict or None.
    The single-request cache is always dense (``max_seq_len`` long)."""

    def prefill(params, lora, buf, n, gen, temp):
        cache = model.init_cache(buf.shape[0], buf.device, page_tokens=0)
        logits = _apply(model, params, buf, lora, decode=True, start_pos=0,
                        cache=cache)
        return _sample_live(logits[0, max(n - 1, 0)], gen, temp, top_k,
                            top_p), cache

    def step(params, lora, cache, tok, pos, gen, temp):
        dev = cache.layers[0]["k"].device
        tok = tok.reshape(1, 1) if isinstance(tok, torch.Tensor) \
            else _token(tok, dev)
        logits = _apply(model, params, tok, lora, decode=True,
                        start_pos=int(pos), cache=cache)
        return _sample_live(logits[0, 0], gen, temp, top_k, top_p), cache

    def tail_block(params, lora, cache, padded_buf, start, n, gen, temp):
        """Replay prompt positions ``start..n-1`` in one forward over a
        fixed ``TAIL_BLOCK`` window of the zero-padded buffer; the stale
        positions past n are rewritten by later steps before any query
        attends them.  Logits are read at the last real position."""
        block = padded_buf[:, start:start + TAIL_BLOCK]
        logits = _apply(model, params, block, lora, decode=True,
                        start_pos=int(start), cache=cache)
        return _sample_live(logits[0, n - 1 - start], gen, temp, top_k,
                            top_p), cache

    return prefill, step, tail_block


def _replay_tail(step_fn, tail_fn, cache, buf, ids, start, n, max_seq,
                 gen, temp):
    """Replay prompt positions ``start..n-1`` onto a cached KV state, the
    one implementation :func:`generate` and the engine's admission share.
    Multi-token tails that fit the fixed block and the context window
    replay as one ``tail_block``; the rest (exact hits, longer tails, the
    window's very end) token by token.  Returns ``(tok, cache)``."""
    tail = n - start
    if 1 < tail <= TAIL_BLOCK and start + TAIL_BLOCK <= max_seq:
        padded = torch.cat([buf, torch.zeros((1, TAIL_BLOCK),
                                             dtype=buf.dtype,
                                             device=buf.device)], dim=1)
        return tail_fn(cache, padded, start, n, gen, temp)
    tok = None
    for j in range(start, n):
        tok, cache = step_fn(cache, ids[j], j, gen, temp)
    return tok, cache


class RequestError(ValueError):
    """Client-side request mistake -> HTTP 4xx."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = int(status)


class PrefixCache:
    """LRU cache of prefill KV states keyed by prompt token prefix.

    ``lookup`` finds the longest common prefix with any entry; an exact hit
    replays the last prompt position (an idempotent rewrite), a prefix hit
    the unseen tail.  Greedy outputs are the same with or without the
    cache.  Entries are clones (the decode path writes its cache in place),
    and a hit hands out a clone of its entry.  ``max_tail`` bounds the
    uncached tail a hit may replay; longer tails miss.  The weights
    (``params``) and adapter the KV was computed under are held by
    reference, and a change of either drops every entry.  Memory:
    ``capacity`` x one full KV buffer."""

    def __init__(self, capacity: int = 8, max_tail: int = TAIL_BLOCK):
        self.capacity = int(capacity)
        self.max_tail = int(max_tail)
        self._entries = collections.OrderedDict()   # tuple(ids) -> cache
        self._lock = threading.Lock()
        self._params_ref = None
        self._lora_ref = None
        self.stats = {"hits": 0, "exact_hits": 0, "misses": 0,
                      "insertions": 0, "invalidations": 0,
                      "prefill_tokens_skipped": 0}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._params_ref = None
            self._lora_ref = None

    def _sync_params(self, params, lora=None) -> None:
        """Caller holds the lock: drop every entry when the weights or the
        adapter change."""
        if self._params_ref is not params or self._lora_ref is not lora:
            if self._entries:
                self.stats["invalidations"] += 1
                self._entries.clear()
            self._params_ref = params
            self._lora_ref = lora

    def lookup(self, ids: List[int], params=None, lora=None):
        """``(c, cache)``: the longest common prefix ``c`` with a cached
        prompt and a clone of its KV, or ``(0, None)``.  A cached buffer
        whose prompt diverges after c is still valid for its first c
        positions: steps attend only positions <= their own and write their
        own position first."""
        t = tuple(ids)
        with self._lock:
            if params is not None:
                self._sync_params(params, lora)
            best, best_key = 0, None
            for key in self._entries:
                c = 0
                for a, b in zip(key, t):
                    if a != b:
                        break
                    c += 1
                if c > best:
                    best, best_key = c, key
            if best_key is not None and len(t) - best <= self.max_tail:
                self._entries.move_to_end(best_key)
                cache = self._entries[best_key]
                self.stats["hits"] += 1
                if best == len(t):
                    self.stats["exact_hits"] += 1
                self.stats["prefill_tokens_skipped"] += min(best, len(t) - 1)
                return best, cache.clone()
            self.stats["misses"] += 1
            return 0, None

    def insert(self, ids: List[int], cache, params=None,
               lora=None) -> None:
        """Keep a clone of ``cache`` under the prompt ``ids``."""
        t = tuple(ids)
        with self._lock:
            if params is not None:
                self._sync_params(params, lora)
            if t in self._entries:
                self._entries.move_to_end(t)
                return
            self._entries[t] = cache.clone()
            self.stats["insertions"] += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)


def generate(apply_fn: Optional[Callable], params, prompt_ids: List[int],
             max_new_tokens: int = 64, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0, seed: int = 0,
             buf_len: int = 256,
             eos_id: Optional[int] = None,
             on_token: Optional[Callable[[int], None]] = None,
             model=None, prefix_cache: Optional[PrefixCache] = None,
             lora=None, device=None) -> List[int]:
    """Sample up to ``max_new_tokens`` continuations of ``prompt_ids``.

    With ``model`` (a module with a decode path whose ``max_seq_len >=
    buf_len``), decode uses the KV cache on the model's device: one
    prefill, then single-token steps; ``lora`` is a flat adapter dict.
    Without it, ``apply_fn(params, tokens)`` must return logits ``(B, T,
    V)`` and each step re-runs it over the padded buffer (on ``device``,
    the card by default)."""
    _check_params(params)
    prompt_ids = list(prompt_ids)[-(buf_len - 1):]
    dev = _model_device(model, device)
    n = len(prompt_ids)
    buf = torch.zeros((1, buf_len), dtype=torch.long, device=dev)
    buf[0, :n] = torch.tensor(prompt_ids, dtype=torch.long)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    temp = float(temperature)
    out: List[int] = []

    with torch.no_grad():
        if model is not None:
            prefill_p, step_p, tail_p = _build_cached_decode(
                model, int(top_k), float(top_p))
            step = lambda c, t, p, g, tp: step_p(params, lora, c, t, p, g, tp)
            tail_blk = lambda c, b, s, m, g, tp: tail_p(params, lora, c, b, s,
                                                        m, g, tp)
            ref = params if params is not None else model
            hit_len, hit_cache = (prefix_cache.lookup(prompt_ids, ref, lora)
                                  if prefix_cache is not None and n > 0
                                  else (0, None))
            if hit_cache is not None:
                start = min(hit_len, n - 1)
                max_seq = getattr(getattr(model, "cfg", None), "max_seq_len",
                                  buf_len)
                tok, cache = _replay_tail(step, tail_blk, hit_cache, buf,
                                          prompt_ids, start, n, max_seq, gen,
                                          temp)
            else:
                tok, cache = prefill_p(params, lora, buf, n, gen, temp)
            if prefix_cache is not None and n > 0:
                prefix_cache.insert(prompt_ids, cache, ref, lora)
            pos = n
            while pos < buf_len and len(out) < max_new_tokens:
                t = int(tok)
                if eos_id is not None and t == eos_id:
                    break
                out.append(t)
                if on_token is not None:
                    on_token(t)
                tok, cache = step(cache, t, pos, gen, temp)
                pos += 1
            return out

        pos = n
        for _ in range(max_new_tokens):
            if pos >= buf_len:
                break
            tok = int(_plain_step(apply_fn, params, buf, pos, gen, temp,
                                  int(top_k), float(top_p)))
            if eos_id is not None and tok == eos_id:
                break
            out.append(tok)
            if on_token is not None:
                on_token(tok)
            buf[0, pos] = tok
            pos += 1
    return out


def _render_chat(messages: List[dict]) -> str:
    """Minimal chat template (the byte tokenizer needs an explicit one)."""
    parts = [f"<|{m.get('role', 'user')}|>\n{m.get('content', '')}"
             for m in messages]
    return "\n".join(parts) + "\n<|assistant|>\n"


class OpenAICompatServer:
    """Serves /v1/models, /v1/completions, /v1/chat/completions (+ SSE
    streaming on chat) over an ``(apply_fn, params)`` pair."""

    def __init__(self, apply_fn: Optional[Callable], params,
                 tokenizer=None, model_name: str = "fedml-tpu-llm",
                 host: str = "127.0.0.1", port: int = 0, buf_len: int = 256,
                 model=None, batch_slots: int = 0, draft_model=None,
                 draft_params=None, decode_horizon: int = 1, spec_k: int = 4,
                 prefix_cache_slots: int = 0,
                 prefix_max_tail: int = TAIL_BLOCK,
                 adapters=None, adapter_slots: int = 0,
                 metrics_port: Optional[int] = None,
                 slo_rules: Optional[List[dict]] = None,
                 kv_page_tokens: int = 0, kv_pool_pages: int = 0,
                 prefill_chunk_tokens: int = 0, prefill_lanes: int = 1,
                 adapter_cache_slots: int = 0,
                 adapter_store_dir: Optional[str] = None):
        """``host`` defaults to loopback: the endpoint is unauthenticated.
        ``model`` (a module with a decode path) turns on KV-cached decode;
        ``batch_slots`` > 0 (needs ``model``) routes requests through the
        :class:`~fedml_tpu_torch.serving.batching.ContinuousBatchingEngine`,
        whose device is the model's.  Sampled requests that also ask for
        ``top_k``/``top_p`` fall through to the single-request path, so the
        fields are honoured.  ``decode_horizon`` > 1 generates that many
        tokens per step call of the engine.  ``kv_page_tokens`` > 0 pages
        the engine's KV cache (``kv_pool_pages``, 0 = enough for every
        slot) with chunked prefill (``prefill_chunk_tokens``,
        ``prefill_lanes``).  ``adapters`` ({name: flat adapter dict}) over a
        ``lora_rank > 0`` model: with ``batch_slots`` they live in an
        :class:`~fedml_tpu_torch.serving.adapters.AdapterRegistry` bank of
        ``adapter_slots`` rows, else each request carries its dict.  A
        request routes to an adapter by ``{"adapter": name}`` or by a
        ``{"model": name}`` other than ``model_name``.
        ``adapter_cache_slots`` > 0 (with ``batch_slots``, in place of
        ``adapter_slots``) makes the bank an N-row cache over an adapter
        store (``adapter_store_dir`` spills cold rows to disk), so more
        adapters register than the bank holds.

        ``draft_model`` and ``draft_params`` (needs ``model``; ``None``
        params are the draft's own weights) turn on
        speculative decode for greedy requests, ``spec_k`` tokens a
        round: with ``batch_slots`` through the
        :class:`~fedml_tpu_torch.serving.batching.SpeculativeBatchingEngine`
        (sampled requests fall through to the single-request path), else
        through :func:`~fedml_tpu_torch.serving.speculative
        .speculative_generate` with the request's adapter.  Both models need
        ``max_seq_len >= buf_len + spec_k + 1`` with the engine; a draft
        refuses ``decode_horizon > 1`` and ``kv_page_tokens``."""
        _check_params(params)
        if draft_model is not None and model is None:
            raise ValueError("draft_model requires `model` (a KV-cached "
                             "target): speculative decode is cache-based")
        _check_params(draft_params)
        self.draft_model = draft_model
        self.draft_params = draft_params
        self.spec_k = int(spec_k)
        self.apply_fn = apply_fn
        self.params = params
        self.tokenizer = tokenizer or ByteTokenizer()
        self.model_name = model_name
        self.host, self.port = host, port
        # /metrics + /healthz beside the API, started and stopped with it
        self.metrics_port = metrics_port
        self.metrics_server = None
        # objective-style SLO rules: into the engine (per-request burn-rate
        # windows) and the metrics endpoint (/healthz)
        self.slo_rules = slo_rules
        self.buf_len = buf_len
        self.model = model
        self.prefix_cache = None
        if prefix_cache_slots and model is None:
            raise ValueError("prefix_cache_slots requires `model` "
                             "(prefix caching is KV-cache-based)")
        if prefix_cache_slots and not batch_slots:
            self.prefix_cache = PrefixCache(prefix_cache_slots,
                                            max_tail=int(prefix_max_tail))
        # serializes weight and adapter swaps against request threads
        # taking a coherent (params, prefix_cache, adapter) snapshot
        self._swap_lock = threading.Lock()
        self.adapters = None
        self._zero_lora = None
        self.registry = None
        if (kv_page_tokens or adapter_cache_slots) and not batch_slots:
            raise ValueError(
                "kv_page_tokens / adapter_cache_slots reshape the batching "
                "engine's memory plane — set batch_slots too")
        if kv_page_tokens and draft_model is not None:
            from ..batching import PagedKVUnsupportedError
            raise PagedKVUnsupportedError(
                "kv_page_tokens with draft_model: the speculative engine "
                "needs contiguous per-slot caches — drop one of the two")
        if adapter_cache_slots and adapter_slots:
            raise ValueError(
                "adapter_cache_slots and adapter_slots are mutually "
                "exclusive: the cache mode replaces the fixed bank")
        if adapters is not None or adapter_slots or adapter_cache_slots:
            if model is None:
                raise ValueError("adapters require `model` (KV-cached "
                                 "decode carries the adapters)")
            if getattr(getattr(model, "cfg", None), "lora_rank", 0) <= 0:
                raise ValueError("adapters require a lora_rank>0 model "
                                 "config (LoRADense layers)")
            if batch_slots and draft_model is not None:
                raise ValueError(
                    "adapters and the speculative batching engine are "
                    "incompatible (it is single-tenant greedy) — drop "
                    "draft_model or batch_slots")
            if batch_slots and not adapter_cache_slots:
                from ..adapters import AdapterRegistry
                cap = int(adapter_slots) or len(adapters or {}) + 8
                self.registry = AdapterRegistry(model, capacity=cap)
                for name, tree in (adapters or {}).items():
                    self.registry.register(name, tree)
            elif not batch_slots:
                self.adapters = dict(adapters or {})
                dev = _model_device(model)
                self._zero_lora = {
                    k: torch.zeros(shape, device=dev)
                    for k, shape in model.lora_shapes().items()}
        self._engine = None
        self._engine_greedy_only = False
        if batch_slots:
            if model is None:
                raise ValueError(
                    "batch_slots requires `model` (a module with a decode "
                    "path) — the batching engine is KV-cache based")
            if draft_model is not None:
                # greedy traffic on the speculative engine; sampled
                # requests fall through to the single-request path
                if int(decode_horizon) > 1:
                    raise ValueError(
                        "decode_horizon and draft_model are mutually "
                        "exclusive: the speculative engine advances up to "
                        "spec_k+1 tokens per tick already")
                from ..batching import SpeculativeBatchingEngine
                self._engine = SpeculativeBatchingEngine(
                    model, params, draft_model, draft_params,
                    slots=int(batch_slots), buf_len=buf_len,
                    k=int(spec_k),
                    prefix_cache_slots=int(prefix_cache_slots),
                    prefix_max_tail=int(prefix_max_tail),
                    slo_rules=slo_rules)
                self._engine_greedy_only = True
            else:
                from ..batching import ContinuousBatchingEngine
                self._engine = ContinuousBatchingEngine(
                    model, params, slots=int(batch_slots), buf_len=buf_len,
                    horizon=int(decode_horizon),
                    prefix_cache_slots=int(prefix_cache_slots),
                    prefix_max_tail=int(prefix_max_tail),
                    adapter_registry=self.registry,
                    slo_rules=slo_rules,
                    kv_page_tokens=int(kv_page_tokens),
                    kv_pool_pages=int(kv_pool_pages),
                    prefill_chunk_tokens=int(prefill_chunk_tokens),
                    prefill_lanes=int(prefill_lanes),
                    adapter_cache_slots=int(adapter_cache_slots),
                    adapter_store_dir=adapter_store_dir)
                if adapter_cache_slots:
                    # the engine owns the store-backed registry; add_adapter
                    # and the fall-through path route through the same one
                    self.registry = self._engine.registry
                    for name, tree in (adapters or {}).items():
                        self.registry.register(name, tree)
            self.prefix_cache = self._engine.prefix_cache
        self._server: Optional[ThreadingHTTPServer] = None

    # -- request handling --------------------------------------------------
    def _complete(self, prompt: str, req: dict,
                  on_text: Optional[Callable[[str], None]] = None,
                  traceparent: Optional[str] = None) -> str:
        """Run generation; ``on_text`` (if given) receives incremental text
        on UTF-8 boundaries (a raw per-token decode would shred multi-byte
        characters with the byte tokenizer).  ``traceparent`` (a validated
        W3C header value) joins the request's span tree to the caller's
        trace."""
        tok = self.tokenizer
        ids: List[int] = []
        sent = 0
        t_submit = time.monotonic()

        def emit(t: int):
            nonlocal sent
            ids.append(t)
            text = tok.decode(ids)
            # trailing replacement chars mark an incomplete UTF-8 sequence
            clean = text.rstrip("�")
            if len(clean) > sent:
                on_text(clean[sent:])
                sent = len(clean)

        adapter_name = req.get("adapter")
        with self._swap_lock:
            if not adapter_name:
                m = req.get("model")
                if (isinstance(m, str) and m and m != self.model_name
                        and (self.adapters is not None
                             or self.registry is not None)):
                    adapter_name = m
            params = self.params
            draft_params = self.draft_params
            prefix_cache = self.prefix_cache
            lora = None
            if self.registry is not None:
                pass  # resolved (and pinned) per path below
            elif self.adapters is not None:
                if adapter_name:
                    if adapter_name not in self.adapters:
                        raise RequestError(
                            f"unknown adapter {adapter_name!r}; have "
                            f"{sorted(self.adapters)}", status=404)
                    lora = self.adapters[adapter_name]
                else:
                    lora = self._zero_lora
            elif adapter_name:
                raise RequestError("server has no adapters configured")

        # JSON nulls for unset optionals: dict.get's default does not apply
        temp = float(req.get("temperature") or 0.0)
        req_top_k = int(req.get("top_k") or 0)
        req_top_p = float(1.0 if req.get("top_p") is None
                          else req.get("top_p"))
        wants_filters = (temp != 0.0
                         and (req_top_k > 0 or req_top_p < 1.0))
        if self._engine is not None and not wants_filters and not (
                self._engine_greedy_only and temp != 0.0):
            try:
                q = self._engine.submit(
                    tok.encode(prompt),
                    max_new_tokens=int(req.get("max_tokens", 64)),
                    temperature=temp,
                    seed=int(req.get("seed", 0)),
                    eos_id=getattr(tok, "eos_id", None),
                    adapter=adapter_name, traceparent=traceparent)
            except KeyError as e:
                raise RequestError(str(e.args[0] if e.args else e),
                                   status=404)
            out = []
            while True:
                try:
                    t = q.get(timeout=300)
                except queue.Empty:
                    break  # engine wedged or crashed: fail the request open
                if t is None:
                    break
                out.append(t)
                if on_text:
                    emit(t)
        else:
            release_row = None
            if self.registry is not None:
                # the fall-through around the multi-tenant engine pins the
                # bank row for the whole generation; a cache-mode miss waits
                # here for the row to page in
                from ..adapters import AdapterMissError
                deadline = time.monotonic() + 30.0
                while True:
                    try:
                        release_row, _atok = self.registry.acquire(
                            adapter_name)
                        break
                    except AdapterMissError:
                        if time.monotonic() >= deadline:
                            raise RequestError(
                                f"adapter {adapter_name!r} did not page "
                                "in within 30s", status=503)
                        time.sleep(0.02)
                    except KeyError as e:
                        raise RequestError(str(e.args[0] if e.args else e),
                                           status=404)
                lora = self.registry.lora_for_row(release_row)
            try:
                if self.draft_model is not None and temp == 0.0:
                    from ..speculative import speculative_generate
                    out, _ = speculative_generate(
                        self.model, params, self.draft_model, draft_params,
                        tok.encode(prompt),
                        max_new_tokens=int(req.get("max_tokens", 64)),
                        buf_len=self.buf_len, k=self.spec_k,
                        eos_id=getattr(tok, "eos_id", None),
                        on_token=emit if on_text else None, lora=lora)
                else:
                    out = generate(
                        self.apply_fn, params, tok.encode(prompt),
                        max_new_tokens=int(req.get("max_tokens", 64)),
                        temperature=temp, top_k=req_top_k,
                        top_p=min(max(req_top_p, 0.0), 1.0),
                        seed=int(req.get("seed", 0)), buf_len=self.buf_len,
                        eos_id=getattr(tok, "eos_id", None),
                        on_token=emit if on_text else None, model=self.model,
                        prefix_cache=(prefix_cache if self._engine is None
                                      else None),
                        lora=lora)
            finally:
                if release_row is not None:
                    self.registry.release(release_row)
            # the engine emits its own request span tree at its finish; the
            # single-request path emits one here (the HTTP thread's lane,
            # host clocks), so every served request has a serve.request
            tracer = get_tracer()
            if tracer.enabled:
                e2e_s = time.monotonic() - t_submit
                tracer.complete(
                    "serve.request", e2e_s, cat="serve",
                    tid=threading.get_ident(),
                    adapter=adapter_name or "base",
                    output_tokens=len(out), e2e_s=round(e2e_s, 6),
                    traceparent=traceparent, path="fallthrough")
        text = tok.decode(out)
        if on_text and len(text) > sent:
            on_text(text[sent:])  # flush any held-back tail
        return text

    def _make_handler(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _send_json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/v1/models":
                    names = [outer.model_name]
                    if outer.registry is not None:
                        names += outer.registry.names()
                    elif outer.adapters is not None:
                        names += sorted(outer.adapters)
                    self._send_json(200, {"object": "list", "data": [
                        {"id": n, "object": "model",
                         "owned_by": "fedml_tpu"} for n in names]})
                elif self.path in ("/ready", "/health"):
                    self._send_json(200, {"ready": True})
                else:
                    self._send_json(404, {"error": "not found"})

            def _sse_stream(self, make_chunk, run):
                """Chunks are flushed as generation emits them."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()

                def write_piece(piece: str):
                    data = json.dumps(make_chunk(piece))
                    self.wfile.write(f"data: {data}\n\n".encode())
                    self.wfile.flush()

                with get_tracer().span("serve.stream", cat="serve"):
                    run(write_piece)
                self.wfile.write(b"data: [DONE]\n\n")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self._send_json(400, {"error": "bad json"})
                    return
                rid = f"cmpl-{uuid.uuid4().hex[:24]}"
                now = int(time.time())
                # a valid W3C traceparent header joins this request's span
                # tree to the caller's trace (a malformed one is dropped)
                tp_raw = self.headers.get("traceparent")
                tparent = tp_raw if (tp_raw and
                                     parse_traceparent(tp_raw)) else None
                try:
                    if self.path == "/v1/chat/completions":
                        prompt = _render_chat(req.get("messages", []))
                        if req.get("stream"):
                            self._sse_stream(
                                lambda p: {
                                    "id": rid, "object":
                                        "chat.completion.chunk",
                                    "created": now, "model": outer.model_name,
                                    "choices": [{"index": 0, "delta":
                                                 {"content": p},
                                                 "finish_reason": None}]},
                                lambda writer: outer._complete(
                                    prompt, req, on_text=writer,
                                    traceparent=tparent))
                            return
                        text = outer._complete(prompt, req,
                                               traceparent=tparent)
                        self._send_json(200, {
                            "id": rid, "object": "chat.completion",
                            "created": now, "model": outer.model_name,
                            "choices": [{"index": 0, "message":
                                         {"role": "assistant",
                                          "content": text},
                                         "finish_reason": "stop"}]})
                    elif self.path == "/v1/completions":
                        text = outer._complete(str(req.get("prompt", "")),
                                               req, traceparent=tparent)
                        self._send_json(200, {
                            "id": rid, "object": "text_completion",
                            "created": now, "model": outer.model_name,
                            "choices": [{"index": 0, "text": text,
                                         "finish_reason": "stop"}]})
                    else:
                        self._send_json(404, {"error": "not found"})
                except RequestError as e:
                    self._send_json(e.status, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — keep serving
                    log.exception("generation failed")
                    self._send_json(500, {"error": str(e)})

            def log_message(self, fmt, *args):
                log.debug("openai-compat: " + fmt, *args)

        return Handler

    def add_adapter(self, name: str, lora_tree) -> None:
        """Register or replace an adapter (a flat adapter dict, e.g. a
        client's LoRA from a federated round).  With the engine this writes
        a bank row (copy-on-write while in-flight requests use the old
        one)."""
        if self.registry is not None:
            self.registry.register(str(name), lora_tree)
            return
        with self._swap_lock:
            if self.adapters is None:
                raise ValueError("server built without adapters= — construct "
                                 "with adapters={} (or batch_slots + "
                                 "adapter_slots) to enable personalization")
            self.adapters[str(name)] = lora_tree

    def evict_adapter(self, name: str) -> None:
        """Stop routing ``name`` (in-flight requests finish on their pinned
        row)."""
        if self.registry is not None:
            self.registry.evict(str(name))
            return
        with self._swap_lock:
            if self.adapters is None or str(name) not in self.adapters:
                raise KeyError(f"unknown adapter {name!r}")
            del self.adapters[str(name)]

    def update_params(self, params, draft_params=None,
                      timeout: float = 60.0) -> None:
        """Swap the serving weights (a federated round boundary).  With the
        engine the swap lands once its in-flight requests drain, and its
        prefix cache clears with it; on ``TimeoutError`` nothing has
        changed.  Without it the prefix cache clears here.
        ``draft_params`` swaps the speculative draft too (optional: a stale
        draft only lowers the acceptance rate)."""
        if draft_params is not None and self.draft_model is None:
            raise ValueError("draft_params given but the server was built "
                             "without draft_model")
        _check_params(params)
        _check_params(draft_params)
        if self._engine is not None:
            if self._engine_greedy_only:
                self._engine.update_params(params, draft_params=draft_params,
                                           timeout=timeout)
            else:
                self._engine.update_params(params, timeout=timeout)
        with self._swap_lock:
            self.params = params
            if draft_params is not None:
                self.draft_params = draft_params
            if self._engine is None and self.prefix_cache is not None:
                self.prefix_cache.clear()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> int:
        self._server = ThreadingHTTPServer((self.host, self.port),
                                           self._make_handler())
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        if self.metrics_port is not None and self.metrics_server is None:
            from ...obs.metricsd import MetricsServer
            extra, objectives = [], None
            if self._engine is not None:
                # the engine's request histograms append to /metrics; its
                # objective windows drive /healthz burn rates
                extra = [self._engine.serve_hists.render_prometheus]
                objectives = self._engine.slo_windows or None
            self.metrics_server = MetricsServer(
                port=int(self.metrics_port), host=self.host,
                slo_rules=self.slo_rules, extra_text=extra,
                objectives=objectives)
            self.metrics_server.start()
        log.info("openai-compatible endpoint on %s:%d", self.host, self.port)
        return self.port

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None
        if self._engine is not None:
            self._engine.stop()
            self._engine = None
