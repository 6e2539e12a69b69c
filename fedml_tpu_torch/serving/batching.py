"""Continuous-batching decode engine (port of
``fedml_tpu.serving.batching.ContinuousBatchingEngine``).

A fixed pool of decode slots shares one batched KV-cache step: every step
call runs the model once over all slots (each at its own depth, a ``(slots,)``
``start_pos``), and waiting requests join freed slots between calls
("continuous batching": requests join and leave at token granularity).
``horizon`` H runs H steps per call with the sampled tokens staying on the
device, so the host reads tokens back once per H.

Two memory planes:

- dense: one :class:`~fedml_tpu_torch.llm.model.KVCache` of ``slots`` rows of
  ``max_seq_len`` positions; admission prefills a request over its padded
  ``buf_len`` buffer and copies the result into its row;
- paged (``kv_page_tokens`` > 0): one page pool per layer and a block table
  per slot (``serving/paged_kv.py``); admission reserves pages (parking the
  request when the pool is dry) and the prompt is prefilled in fixed
  ``prefill_chunk_tokens`` chunks, ``prefill_lanes`` slots a tick, between
  the decode steps.

Multi-tenant LoRA: with an :class:`~fedml_tpu_torch.serving.adapters
.AdapterRegistry` each slot carries a bank row and the step applies
``bank[rows]`` as grouped adapter products (row 0 is the zero adapter).
``adapter_cache_slots`` N makes the bank an N-row cache over a host (and,
with ``adapter_store_dir``, disk) adapter store: a request whose adapter is
not resident parks while its row pages in, and the pin is taken at
admission.

:class:`SpeculativeBatchingEngine` runs continuous batching with a draft
model (greedy only): each tick one draft catch-up and k-token proposal for
every slot, then one (k+1)-token target verify, per-row starts in one
batch where the JAX package ``vmap``s a one-row program.

Greedy output is the same as the single-request
:func:`~fedml_tpu_torch.serving.templates.openai_compat.generate` path,
and a sampled request draws from its own ``torch.Generator`` in the same
order there and here.  A daemon thread drives the card, its device set
explicitly.

Observability, as the JAX engine's: per-request lifecycle histograms
(``ServeHistograms``, ``hist_labels`` adapter labels) and objective windows
(``slo_rules``), a ``/metrics`` endpoint (``metrics_port``), and, when the
tracer is on, each request's span tree (``serve.request`` with its
``traceparent``, ``serve.queue``, ``serve.decode``; the live
``serve.admit``/``serve.prefill`` spans) and the loop's ``serve.*``
counters.  They read host clocks and host ints only: the hooks add no
device sync (``analysis/runtime.py::TorchRuntimeAudit`` counts them on
the card).
"""

from __future__ import annotations

import logging
import math
import os
import queue
import threading
import time
from functools import partial
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..obs import get_tracer
from ..obs.histogram import ServeHistograms
from .adapters import AdapterMissError, AdapterRegistry
from .paged_kv import PagedBlockPool, PagedPrefixCache, PageExhaustedError
from .speculative import propose_block, sync_rows, verify_greedy_block
from .templates.openai_compat import (TAIL_BLOCK, PrefixCache, _apply,
                                      _build_cached_decode, _check_params,
                                      _replay_tail, _sample_live,
                                      _sample_rows)

log = logging.getLogger(__name__)


class PagedKVUnsupportedError(ValueError):
    """Raised at construction for a paged target or draft in the
    speculative engine: its verify and propose blocks write multi-token
    windows into contiguous per-slot caches, which a shared page pool is
    not."""


class _UnservableError(Exception):
    """A request whose page reservation can never succeed on this pool
    (it needs more than all non-trash pages): failed open, not parked."""


class _Slot:
    __slots__ = ("live", "q", "pos", "remaining", "eos_id", "cur_tok",
                 "adapter_row", "gen",
                 # paged prefill state (free -> prefilling -> live): prompt
                 # ids and replay cursor, adapter token, reserved blocks
                 "prefilling", "pf_ids", "pf_next", "pf_n", "pf_atok",
                 "n_blocks",
                 # request-lifecycle telemetry (host monotonic clocks,
                 # engine-thread-confined like the decode state)
                 "t_submit", "t_admit", "t_prefill_end", "t_first",
                 "prompt_tokens", "out_tokens", "adapter_label",
                 "traceparent",
                 # speculative engine: this request's draft proposals
                 "drafts_proposed", "drafts_accepted")

    def __init__(self):
        self.live = False
        self.q: Optional[queue.Queue] = None
        self.pos = 0
        self.remaining = 0
        self.eos_id: Optional[int] = None
        self.cur_tok = 0
        self.adapter_row = 0
        self.gen: Optional[torch.Generator] = None
        self.prefilling = False
        self.pf_ids: Optional[List[int]] = None
        self.pf_next = 0
        self.pf_n = 0
        self.pf_atok = None
        self.n_blocks = 0
        self.t_submit = 0.0
        self.t_admit: Optional[float] = None
        self.t_prefill_end = 0.0
        self.t_first: Optional[float] = None
        self.prompt_tokens = 0
        self.out_tokens = 0
        self.adapter_label = "base"
        self.traceparent: Optional[str] = None
        self.drafts_proposed = 0
        self.drafts_accepted = 0


class ContinuousBatchingEngine:
    """``submit()`` returns a queue that yields generated token ids and then
    ``None``; a daemon thread drives the batched decode loop on the model's
    device.  ``params``: None (the model's own weights) or a ``{name:
    tensor}`` dict."""

    def __init__(self, model, params, slots: int = 4, buf_len: int = 256,
                 top_k: int = 0, top_p: float = 1.0, horizon: int = 1,
                 prefix_cache_slots: int = 0,
                 prefix_max_tail: int = TAIL_BLOCK,
                 adapter_registry: Optional[AdapterRegistry] = None,
                 adapter_slots: int = 0,
                 metrics_port: Optional[int] = None,
                 hist_labels: int = 8,
                 slo_rules: Optional[List[Dict[str, Any]]] = None,
                 kv_page_tokens: int = 0, kv_pool_pages: int = 0,
                 prefill_chunk_tokens: int = 0, prefill_lanes: int = 1,
                 adapter_cache_slots: int = 0,
                 adapter_store_dir: Optional[str] = None):
        tp = getattr(model, "tp", None)
        if tp is not None and tp.size > 1:
            raise NotImplementedError(
                f"a tensor-parallel model over {tp.size} ranks: the "
                "batching engine runs on one card, as in the JAX package "
                "(tensor-parallel decode is generate's)")
        _check_params(params)
        # per-request lifecycle histograms, bounded to hist_labels adapter
        # labels (+ "other"), and the objective windows of slo_rules
        self.serve_hists = ServeHistograms(max_labels=int(hist_labels))
        self.slo_windows: Dict[str, Any] = {}
        if slo_rules:
            from ..obs.slo import windows_for_rules
            self.slo_windows = windows_for_rules(slo_rules)
        # metrics_port serves /metrics + /healthz over the tracer's serve.*
        # gauges, the histograms appended, the windows behind /healthz
        self.metrics_server = None
        if metrics_port is not None:
            from ..obs.metricsd import MetricsServer
            self.metrics_server = MetricsServer(
                port=int(metrics_port), slo_rules=slo_rules,
                extra_text=[self.serve_hists.render_prometheus],
                objectives=self.slo_windows or None)
            self.metrics_server.start()
        self.model = model
        self.device = next(model.parameters()).device
        self.raw_params = params
        self.n_slots = int(slots)
        self.buf_len = int(buf_len)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.registry = adapter_registry
        self._owns_registry = False
        if adapter_cache_slots and self.registry is None:
            from .adapter_store import AdapterStore
            store = AdapterStore(
                model, spill_dir=adapter_store_dir,
                max_resident_pages=(16 if adapter_store_dir else 0))
            self.registry = AdapterRegistry(
                model, capacity=int(adapter_cache_slots), store=store)
            self._owns_registry = True
        elif adapter_slots and self.registry is None:
            self.registry = AdapterRegistry(model, capacity=int(adapter_slots))
            self._owns_registry = True
        # cache mode: the pin is taken at admission (the engine thread owns
        # page-in and install), and a fetch that lands wakes the loop
        self._store_mode = (self.registry is not None
                            and self.registry.store is not None)
        self.horizon = max(1, int(horizon))

        self.kv_page_tokens = int(kv_page_tokens)
        self.paged = self.kv_page_tokens > 0
        self.page_pool = None
        if self.paged:
            ptok = self.kv_page_tokens
            self.prefill_chunk = int(prefill_chunk_tokens) or \
                min(64, self.buf_len)
            self.prefill_lanes = max(1, int(prefill_lanes))
            # the block-table window covers buf_len plus the worst
            # chunk-padding / horizon overhang, so every write past a
            # reservation lands on a real (trash) table entry
            overhang = max(self.prefill_chunk, self.horizon)
            self.max_blocks = math.ceil((self.buf_len + overhang) / ptok)
            # pages one slot may ever reserve (positions < buf_len)
            self.blocks_cap = math.ceil(self.buf_len / ptok)
            pool_pages = int(kv_pool_pages) or \
                (1 + self.n_slots * self.blocks_cap)
            self.kv_pool_pages = pool_pages
            self.page_pool = PagedBlockPool(pool_pages)
            self._btabs = np.zeros((self.n_slots, self.max_blocks),
                                   np.int32)
            self._chunks_total = 0
            self._pages_shared = 0
            self._pages_private = 0

        self._prefill, self._tail_step, self._tail_block = \
            _build_cached_decode(model, self.top_k, self.top_p)
        # paged engines share prefix pages (refcounts), dense ones copy KV
        self.prefix_cache = None
        if prefix_cache_slots:
            if self.paged:
                self.prefix_cache = PagedPrefixCache(
                    prefix_cache_slots, self.kv_page_tokens, self.page_pool)
            else:
                self.prefix_cache = PrefixCache(prefix_cache_slots,
                                                max_tail=int(prefix_max_tail))

        with torch.no_grad():
            if self.paged:
                self._caches = None
                self._pool = model.init_cache(
                    0, self.device, page_tokens=self.kv_page_tokens,
                    pool_pages=self.kv_pool_pages)
            else:
                self._caches = model.init_cache(self.n_slots, self.device,
                                                page_tokens=0)
                self._pool = None

        self._slots = [_Slot() for _ in range(self.n_slots)]
        self._toks = np.zeros(self.n_slots, np.int64)
        self._poss = np.zeros(self.n_slots, np.int64)
        self._temps = np.zeros(self.n_slots, np.float32)
        self._aids = np.zeros(self.n_slots, np.int64)
        self._waiting: "queue.Queue[dict]" = queue.Queue()
        # requests taken off _waiting but not admittable yet (page pool
        # dry); engine-thread-confined, retried before new admissions
        self._parked: List[dict] = []
        # set under _cond by the adapter fetch worker, and by a finish that
        # released a pin or pages; cleared by the parked-retry pass
        self._fetch_ready = False
        self._pin_released = False
        self._cond = threading.Condition()
        self._stopped = False
        # weight swap staged by update_params(); applied by the engine
        # thread once live slots drain (admission pauses meanwhile)
        self._pending_params = None
        self._ticks = 0
        # host-side serving telemetry (always kept; mirrored onto tracer
        # counters when tracing is on: host ints only, no device sync)
        self.serve_stats: Dict[str, Any] = {
            "admits": 0, "tokens": 0, "requests": {}}
        self._tok_window = [time.monotonic(), 0]
        # guards serve_stats and _tok_window; innermost (taken alone or
        # inside _cond, never the reverse)
        self._stats_lock = threading.Lock()
        if self._store_mode:
            self.registry.on_fetch_done = self._on_adapter_fetched
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- public api --------------------------------------------------------
    def submit(self, prompt_ids: List[int], max_new_tokens: int = 64,
               temperature: float = 0.0, seed: int = 0,
               eos_id: Optional[int] = None,
               adapter: Optional[str] = None,
               traceparent: Optional[str] = None) -> "queue.Queue":
        """Enqueue a request; returns a queue yielding token ids then
        ``None``.  ``adapter`` names a registered bank row (``KeyError`` for
        unknown names), pinned until the request finishes.
        ``traceparent`` (a W3C header value) joins the request's span tree
        to the caller's trace."""
        out: "queue.Queue" = queue.Queue()
        row, atok = 0, None
        if self._store_mode:
            # the name is checked here, the pin deferred to admission
            if adapter is not None and adapter not in self.registry:
                raise KeyError(f"unknown adapter {adapter!r}; have "
                               f"{self.registry.names()}")
        elif self.registry is not None:
            row, atok = self.registry.acquire(adapter)
        elif adapter:
            raise ValueError("engine built without an adapter registry "
                             f"(adapter_slots=0) — cannot route {adapter!r}")
        try:
            with self._cond:
                if self._stopped or not self._thread.is_alive():
                    raise RuntimeError("engine stopped")
                name = adapter if adapter is not None else "base"
                self._waiting.put({
                    "prompt_ids": list(prompt_ids)[-(self.buf_len - 1):],
                    "max_new_tokens": int(max_new_tokens),
                    "temperature": float(temperature),
                    "seed": int(seed),
                    "eos_id": eos_id,
                    "adapter": adapter,
                    "adapter_row": row,
                    "adapter_token": atok,
                    "adapter_label": name,
                    "traceparent": traceparent,
                    "t_submit": time.monotonic(),
                    "q": out,
                })
                with self._stats_lock:
                    reqs = self.serve_stats["requests"]
                    reqs[name] = reqs.get(name, 0) + 1
                    nreq = reqs[name]
                # bounded-cardinality request counter: one metric with an
                # adapter label (at most hist_labels + "other"); the old
                # per-adapter metric names only behind the legacy flag
                label, label_n = self.serve_hists.labels.resolve(name)
                tracer = get_tracer()
                if tracer.enabled:
                    tracer.counter("serve.requests_by_adapter", label_n,
                                   adapter=label)
                    if os.environ.get(
                            "FEDML_SERVE_LEGACY_ADAPTER_COUNTERS") == "1":
                        tracer.counter(f"serve.requests.{name}", nreq)
                self._cond.notify()
        except BaseException:
            if self.registry is not None:
                self.registry.release(row)
            raise
        return out

    def generate(self, prompt_ids: List[int], **kw) -> List[int]:
        """Blocking convenience wrapper over :meth:`submit`."""
        q = self.submit(prompt_ids, **kw)
        out: List[int] = []
        while True:
            t = q.get()
            if t is None:
                return out
            out.append(t)

    def update_params(self, params, wait: bool = True,
                      timeout: float = 60.0) -> None:
        """Swap the serving weights (a federated round boundary): staged,
        and applied by the engine thread once in-flight slots drain
        (admission pauses meanwhile), so every request is served by one
        weight version; the prefix cache clears with the swap.  On
        ``TimeoutError`` the swap stays staged."""
        _check_params(params)
        with self._cond:
            if self._stopped or not self._thread.is_alive():
                raise RuntimeError("engine stopped")
            self._pending_params = (params,)
            self._cond.notify_all()
            if not wait:
                return
            deadline = time.monotonic() + timeout
            while self._pending_params is not None:
                if self._stopped or not self._thread.is_alive():
                    raise RuntimeError("engine stopped during weight swap")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        "weight swap did not land within "
                        f"{timeout}s (in-flight requests still draining)")
                self._cond.wait(timeout=min(0.5, remaining))

    def _on_adapter_fetched(self, name: str) -> None:
        """Fetch-worker callback (cache mode): wake the loop so requests
        parked on a miss retry."""
        with self._cond:
            self._fetch_ready = True
            self._cond.notify()

    def _on_swap(self) -> None:
        """Called on the engine thread when a staged weight swap lands."""

    def stop(self):
        self._stopped = True
        with self._cond:
            self._cond.notify()
        self._thread.join(timeout=10)
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None
        if self._owns_registry and self.registry is not None:
            self.registry.close()

    def step_programs(self):
        """The engine's device programs as ``(name, fn, args)`` on their
        resting buffers: ``decode_step`` is what each tick calls (``fn(*args)``
        runs one horizon of it and returns the ``(slots, horizon)`` tokens),
        and ``insert_cache`` (dense) or ``prefill_chunk`` (paged) the
        admission write."""
        dev = self.device
        toks = torch.as_tensor(self._toks, device=dev)
        poss = torch.as_tensor(self._poss, device=dev)
        aids = torch.as_tensor(self._aids, device=dev)
        temps = [0.0] * self.n_slots
        gens = [None] * self.n_slots
        if self.paged:
            btabs = torch.as_tensor(self._btabs, device=dev)
            lora = (self.registry.lora_for_row(0)
                    if self.registry is not None else None)
            chunk_args = (self.raw_params, lora, self._pool,
                          torch.zeros((1, self.prefill_chunk),
                                      dtype=torch.long, device=dev),
                          torch.zeros((1, self.max_blocks), dtype=torch.long,
                                      device=dev), 0)
            return [
                ("decode_step", self._decode_step,
                 (self.raw_params, aids, self._pool, btabs, toks, poss,
                  gens, temps)),
                ("prefill_chunk", self._chunk, chunk_args),
            ]
        return [
            ("decode_step", self._decode_step,
             (self.raw_params, aids, self._caches, None, toks, poss, gens,
              temps)),
            ("insert_cache", self._caches.copy_rows_,
             (slice(0, 1), self._caches.rows(slice(0, 1)).clone())),
        ]

    def kv_stats(self) -> Dict[str, Any]:
        """Host-side memory-plane stats: pool occupancy, chunk counts,
        prefix page sharing, adapter bank counters."""
        with self._stats_lock:
            out: Dict[str, Any] = {"ticks": self._ticks}
            if self.paged:
                chunks = self._chunks_total
                shared, private = self._pages_shared, self._pages_private
        if self.paged:
            out["pool"] = dict(self.page_pool.stats)
            out["pages_free"] = self.page_pool.pages_free
            out["pool_pages"] = self.page_pool.n_pages
            out["prefill_chunks"] = chunks
            out["pages_shared"] = shared
            out["pages_private"] = private
            if self.prefix_cache is not None:
                out["prefix"] = dict(self.prefix_cache.stats)
        if self.registry is not None:
            out["adapter"] = dict(self.registry.stats)
        return out

    # -- device programs -----------------------------------------------------
    def _params_ref(self):
        """What the prefix caches key KV validity on: the weight dict, or
        the model when it serves its own weights."""
        return self.raw_params if self.raw_params is not None else self.model

    def _decode_step(self, params, aids, cache, btabs, toks, poss, gens,
                     temps):
        """``horizon`` batched steps over every slot; the sampled tokens
        feed the next step on the device.  Returns ``(slots, horizon)``
        tokens on the device."""
        lora = self.registry.gather(aids) if self.registry is not None \
            else None
        hist = []
        for _ in range(self.horizon):
            logits = _apply(self.model, params, toks[:, None], lora,
                            decode=True, start_pos=poss, cache=cache,
                            block_tables=btabs)
            toks = _sample_rows(logits[:, 0], gens, temps, self.top_k,
                                self.top_p)
            hist.append(toks)
            poss = poss + 1
        return torch.stack(hist, dim=1)

    def _chunk(self, params, lora, pool, chunk, btab, start):
        """One ``(1, C)`` prefill chunk of one slot into the pool; returns
        its logits."""
        return _apply(self.model, params, chunk, lora, decode=True,
                      start_pos=torch.tensor([start], device=chunk.device),
                      cache=pool, block_tables=btab)

    # -- engine loop -------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if not s.live and not s.prefilling:
                return i
        return None

    def _finish(self, i: int, aborted: bool = False):
        s = self._slots[i]
        if not aborted and s.t_admit is not None:
            self._observe_finish(i, s)
        s.t_admit = None
        s.live = False
        s.prefilling = False
        s.pf_ids = None
        s.gen = None
        if self.paged and s.n_blocks:
            # drop the slot's hold on its pages (shared prefix pages
            # survive under the cache or other sharers)
            self.page_pool.release(
                [int(p) for p in self._btabs[i, :s.n_blocks]])
            self._btabs[i, :] = 0
            s.n_blocks = 0
        if s.q is not None:
            s.q.put(None)
        s.q = None
        if self.registry is not None and s.adapter_row:
            self.registry.release(s.adapter_row)
            s.adapter_row = 0
        self._pin_released = True

    def _observe_finish(self, i: int, s: "_Slot") -> None:
        """Request-lifecycle telemetry at a natural finish (engine thread,
        host clocks only): the phase breakdown into the histograms and the
        objective windows, and, when tracing is on, a retroactive span tree
        on a per-slot synthetic lane (one slot's requests never overlap)."""
        now = time.monotonic()
        queue_s = max(s.t_admit - s.t_submit, 0.0)
        prefill_s = max(s.t_prefill_end - s.t_admit, 0.0)
        e2e_s = max(now - s.t_submit, 0.0)
        decode_s = max(now - s.t_prefill_end, 0.0)
        ttft_s = max(s.t_first - s.t_submit, 0.0) \
            if s.t_first is not None else None
        self.serve_hists.record_request(
            s.adapter_label, queue_s=queue_s, prefill_s=prefill_s,
            e2e_s=e2e_s, ttft_s=ttft_s, decode_s=decode_s,
            output_tokens=s.out_tokens)
        for win in self.slo_windows.values():
            v = {"serve_ttft_seconds": ttft_s,
                 "serve_e2e_seconds": e2e_s,
                 "serve_queue_wait_seconds": queue_s,
                 "serve_prefill_seconds": prefill_s,
                 "serve_decode_seconds": decode_s}.get(win.metric)
            if v is not None:
                win.observe(v)
        tracer = get_tracer()
        if not tracer.enabled:
            return
        lane = -16 - i   # per-slot synthetic lane, clear of COMPILE_TID
        tracer.complete(
            "serve.request", e2e_s, cat="serve", tid=lane,
            adapter=s.adapter_label, slot=i,
            prompt_tokens=s.prompt_tokens, output_tokens=s.out_tokens,
            queue_s=round(queue_s, 6), prefill_s=round(prefill_s, 6),
            ttft_s=round(ttft_s, 6) if ttft_s is not None else None,
            decode_s=round(decode_s, 6), e2e_s=round(e2e_s, 6),
            traceparent=s.traceparent,
            drafts_proposed=s.drafts_proposed or None,
            drafts_accepted=(s.drafts_accepted if s.drafts_proposed
                             else None))
        tracer.complete("serve.queue", queue_s, cat="serve", tid=lane,
                        end_s_ago=max(e2e_s - queue_s, 0.0), slot=i)
        tracer.complete("serve.decode", decode_s, cat="serve", tid=lane,
                        slot=i)

    def _start_request(self, s: "_Slot", req: dict, t_admit: float,
                       t_prefill_end: float, n: int) -> None:
        """The slot's lifecycle telemetry for an admitted request."""
        s.t_submit = req.get("t_submit", t_admit)
        s.t_admit = t_admit
        s.t_prefill_end = t_prefill_end
        s.t_first = None
        s.prompt_tokens = n
        s.out_tokens = 0
        s.adapter_label = req.get("adapter_label", "base")
        s.traceparent = req.get("traceparent")
        s.drafts_proposed = 0
        s.drafts_accepted = 0

    def _emit(self, i: int, tok: int) -> bool:
        """Deliver one sampled token; False when the slot is done (eos,
        budget, buffer end), with ``generate()``'s delivery rules: eos is
        not delivered, nor a token whose successor would fall outside the
        buffer."""
        s = self._slots[i]
        if s.remaining <= 0 or s.pos >= self.buf_len:
            return False
        if s.eos_id is not None and tok == s.eos_id:
            return False
        s.q.put(tok)
        s.remaining -= 1
        s.cur_tok = tok
        if s.t_first is None:
            s.t_first = time.monotonic()
        s.out_tokens += 1
        with self._stats_lock:
            self.serve_stats["tokens"] += 1
            self._tok_window[1] += 1
        return s.remaining > 0 and s.pos < self.buf_len

    def _new_gen(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return gen

    def _admit(self, req: dict, slot: int):
        """Dense admission: prefill (or a prefix-cache replay) into a
        one-row cache, then copy it into the slot's row."""
        t_admit = time.monotonic()
        ids = req["prompt_ids"]
        n = len(ids)
        buf = torch.zeros((1, self.buf_len), dtype=torch.long,
                          device=self.device)
        buf[0, :n] = torch.tensor(ids, dtype=torch.long)
        gen = self._new_gen(req["seed"])
        temp = req["temperature"]
        row = req.get("adapter_row", 0)
        atok = req.get("adapter_token")
        lora = (self.registry.lora_for_row(row)
                if self.registry is not None else None)
        ref = self._params_ref()
        hit_len, hit_cache = (self.prefix_cache.lookup(ids, ref, atok)
                              if self.prefix_cache is not None and n > 0
                              else (0, None))
        # serve.prefill, the one live phase span (inside the caller's
        # serve.admit), closes on the int() below: the admission's own
        # read-back, not a new sync
        with get_tracer().span("serve.prefill", cat="serve", slot=slot,
                               prompt_tokens=n,
                               cache_hit=int(hit_cache is not None)):
            if hit_cache is not None:
                start = min(hit_len, n - 1)
                max_seq = getattr(getattr(self.model, "cfg", None),
                                  "max_seq_len", self.buf_len)
                tok, cache = _replay_tail(
                    partial(self._tail_step, self.raw_params, lora),
                    partial(self._tail_block, self.raw_params, lora),
                    hit_cache, buf, ids, start, n, max_seq, gen, temp)
            else:
                tok, cache = self._prefill(self.raw_params, lora, buf, n,
                                           gen, temp)
            tok_host = int(tok)
        t_prefill_end = time.monotonic()
        if self.prefix_cache is not None and n > 0:
            self.prefix_cache.insert(ids, cache, ref, atok)
        self._caches.copy_rows_(slice(slot, slot + 1), cache)
        s = self._slots[slot]
        s.live = True
        s.q = req["q"]
        s.pos = n
        s.remaining = req["max_new_tokens"]
        s.eos_id = req["eos_id"]
        s.adapter_row = row
        s.gen = gen
        self._start_request(s, req, t_admit, t_prefill_end, n)
        self._aids[slot] = row
        self._temps[slot] = temp
        if not self._emit(slot, tok_host):
            self._finish(slot)

    # -- paged admission ---------------------------------------------------
    def _reserve_pages(self, req: dict, slot: int) -> None:
        """Wire ``slot``'s block table: the longest shareable prefix pages
        (incref'd) and fresh private pages for the rest of the request's
        worst-case window.  :class:`PageExhaustedError` when the pool is dry
        (the caller parks), :class:`_UnservableError` when it can never
        fit (the caller fails it open)."""
        ids = req["prompt_ids"]
        n = len(ids)
        ptok = self.kv_page_tokens
        need = min(n + req["max_new_tokens"], self.buf_len)
        need_blocks = max(1, math.ceil(need / ptok))
        if need_blocks > self.page_pool.n_pages - 1:
            raise _UnservableError(
                f"request needs {need_blocks} pages; pool has "
                f"{self.page_pool.n_pages - 1} usable")
        atok = req.get("adapter_token")
        full, shared = (self.prefix_cache.lookup(ids, self._params_ref(),
                                                 atok)
                        if self.prefix_cache is not None and n > 0
                        else (0, []))
        # incref the lent pages first: evict_for_pages below may drop the
        # very entry matched, and only this hold keeps its pages alive
        self.page_pool.share(shared)
        priv = need_blocks - full
        try:
            if not self.page_pool.can_reserve(priv) \
                    and self.prefix_cache is not None:
                self.prefix_cache.evict_for_pages(priv)
            pages = self.page_pool.reserve(priv)
        except PageExhaustedError:
            self.page_pool.release(shared)
            raise
        self._btabs[slot, :] = 0
        self._btabs[slot, :full] = shared
        self._btabs[slot, full:need_blocks] = pages
        req["_kv"] = (full, need_blocks)
        with self._stats_lock:
            self._pages_shared += full
            self._pages_private += priv

    def _admit_paged(self, req: dict, slot: int) -> None:
        """Enter the prefilling state: the block table is wired; the chunk
        lanes in :meth:`_prefill_tick` replay the prompt from the shared
        page boundary and make the slot live on the final chunk."""
        t_admit = time.monotonic()
        ids = req["prompt_ids"]
        full, need_blocks = req.pop("_kv")
        s = self._slots[slot]
        s.prefilling = True
        s.live = False
        s.q = req["q"]
        s.pos = 0
        s.remaining = req["max_new_tokens"]
        s.eos_id = req["eos_id"]
        s.cur_tok = 0
        s.adapter_row = req.get("adapter_row", 0)
        s.gen = self._new_gen(req["seed"])
        s.pf_ids = ids
        s.pf_n = len(ids)
        s.pf_next = full * self.kv_page_tokens
        s.pf_atok = req.get("adapter_token")
        s.n_blocks = need_blocks
        self._start_request(s, req, t_admit, t_admit, len(ids))
        self._aids[slot] = s.adapter_row
        self._temps[slot] = req["temperature"]

    def _prefill_tick(self) -> None:
        """Run up to ``prefill_lanes`` fixed-shape prefill chunks, one per
        prefilling slot, so a long prompt costs each tick one chunk rather
        than a stall.  Only the final chunk samples (the request's first
        draw)."""
        lanes = self.prefill_lanes
        C = self.prefill_chunk
        for i, s in enumerate(self._slots):
            if lanes <= 0:
                break
            if not s.prefilling:
                continue
            lanes -= 1
            cs = s.pf_next
            n = s.pf_n
            chunk = torch.zeros((1, C), dtype=torch.long, device=self.device)
            seg = s.pf_ids[cs:cs + C]
            chunk[0, :len(seg)] = torch.tensor(seg, dtype=torch.long)
            final = cs + C >= n
            lora = (self.registry.lora_for_row(s.adapter_row)
                    if self.registry is not None else None)
            btab = torch.as_tensor(self._btabs[i][None], device=self.device)
            logits = self._chunk(self.raw_params, lora, self._pool, chunk,
                                 btab, cs)
            with self._stats_lock:
                self._chunks_total += 1
            if not final:
                s.pf_next = cs + C
                continue
            tok_host = int(_sample_live(logits[0, max(n - 1 - cs, 0)], s.gen,
                                        float(self._temps[i]), self.top_k,
                                        self.top_p))
            s.prefilling = False
            s.live = True
            s.pos = n
            s.t_prefill_end = time.monotonic()
            if self.prefix_cache is not None and n > 0:
                fullpages = n // self.kv_page_tokens
                if fullpages:
                    self.prefix_cache.insert(
                        s.pf_ids,
                        [int(p) for p in self._btabs[i, :fullpages]],
                        self._params_ref(), s.pf_atok)
            s.pf_ids = None
            if not self._emit(i, tok_host):
                self._finish(i)

    def _admit_one(self, req: dict, slot: int, tracer) -> bool:
        """The cache-mode adapter pin and the page reservation (paged
        engines), then the admission.  False when the request parked (its
        adapter paging in, or the pool dry) or failed open."""
        try:
            if (self._store_mode and req.get("adapter") is not None
                    and req.get("adapter_token") is None):
                row, atok = self.registry.acquire(req["adapter"])
                req["adapter_row"], req["adapter_token"] = row, atok
            if self.paged:
                self._reserve_pages(req, slot)
        except AdapterMissError:
            req["_park_reason"] = "adapter"
            self._parked.append(req)
            return False
        except PageExhaustedError:
            # drop a pin just taken, so a parked request holds no row
            if self._store_mode and req.get("adapter_row"):
                self.registry.release(req["adapter_row"])
                req["adapter_row"], req["adapter_token"] = 0, None
            req["_park_reason"] = "pages"
            self._parked.append(req)
            return False
        except (_UnservableError, KeyError, RuntimeError):
            # an unservable reservation, an adapter evicted since submit,
            # or a failed fetch: fail this request open
            if self.registry is not None and req.get("adapter_row"):
                self.registry.release(req["adapter_row"])
            req["q"].put(None)
            return False
        with tracer.span("serve.admit", cat="serve", slot=slot,
                         adapter_row=req.get("adapter_row", 0)):
            if self.paged:
                self._admit_paged(req, slot)
            else:
                self._admit(req, slot)
        with self._stats_lock:
            self.serve_stats["admits"] += 1
        return True

    def _drain_waiting(self):
        """Fail open every queued and parked request (caller holds
        ``_cond``), dropping adapter pins."""
        while not self._waiting.empty():
            req = self._waiting.get()
            req["q"].put(None)
            if self.registry is not None and req.get("adapter_row"):
                self.registry.release(req["adapter_row"])
        for req in self._parked:
            req["q"].put(None)
            if self.registry is not None and req.get("adapter_row"):
                self.registry.release(req["adapter_row"])
        self._parked.clear()

    def _parked_actionable(self) -> bool:
        """Caller holds ``_cond``: is a parked retry worth waking for?
        Page-parked requests retry whenever pages may have freed;
        adapter-parked ones once a fetch landed or a pin was released."""
        if not self._parked:
            return False
        if self._fetch_ready or self._pin_released:
            return True
        return any(r.get("_park_reason") == "pages" for r in self._parked)

    def _run(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            with torch.no_grad():
                self._run_loop()
        except Exception:  # noqa: BLE001 — a dead engine must not hang HTTP
            log.exception("continuous-batching engine crashed; failing open")
            with self._cond:  # excludes concurrent submit() puts
                self._stopped = True
                for i, s in enumerate(self._slots):
                    if s.live or s.prefilling:
                        self._finish(i, aborted=True)
                self._drain_waiting()
                self._cond.notify_all()  # wake update_params waiters

    def _run_loop(self):
        while True:
            with self._cond:
                while (not self._stopped and self._waiting.empty()
                       and self._pending_params is None
                       and not any(s.live or s.prefilling
                                   for s in self._slots)
                       and not self._parked_actionable()):
                    self._cond.wait(timeout=0.5)
                if self._stopped:
                    for i, s in enumerate(self._slots):
                        if s.live or s.prefilling:
                            self._finish(i, aborted=True)
                    self._drain_waiting()
                    self._cond.notify_all()
                    return
                # a staged weight swap lands once in-flight slots drain
                # (prefilling ones too: their KV is half-written under the
                # old weights); the prefix cache clears with it
                swap_pending = self._pending_params is not None
                if swap_pending and not any(s.live or s.prefilling
                                            for s in self._slots):
                    self.raw_params = self._pending_params[0]
                    self._pending_params = None
                    if self.prefix_cache is not None:
                        self.prefix_cache.clear()
                    self._on_swap()
                    swap_pending = False
                    self._cond.notify_all()
                retry_parked = bool(self._parked) and not swap_pending
                if retry_parked:
                    self._fetch_ready = False
                    self._pin_released = False

            # admission is paused while a swap waits for the drain; parked
            # requests retry first, and a parked head never blocks fresh
            # admissions behind it
            tracer = get_tracer()
            if retry_parked:
                retry, self._parked = self._parked, []
                for j, req in enumerate(retry):
                    slot = self._free_slot()
                    if slot is None:
                        self._parked.extend(retry[j:])
                        break
                    self._admit_one(req, slot, tracer)
            while not swap_pending and not self._waiting.empty():
                slot = self._free_slot()
                if slot is None:
                    break
                self._admit_one(self._waiting.get(), slot, tracer)
            if tracer.enabled:
                tracer.counter("serve.queue_depth",
                               self._waiting.qsize() + len(self._parked))

            if self.paged:
                self._prefill_tick()
            live = [i for i, s in enumerate(self._slots) if s.live]
            if live:
                self._dispatch(live)
                with self._stats_lock:
                    self._ticks += 1
            elif not any(s.prefilling for s in self._slots):
                continue
            if tracer.enabled:
                self._loop_counters(tracer)

    def _loop_counters(self, tracer) -> None:
        """The loop's ``serve.*`` counters, from host ints: the token
        rate over a window of at least 0.5 s and the running total, the
        page pool, the chunk count and the adapter cache."""
        now = time.monotonic()
        rolled = None
        with self._stats_lock:
            t0, ntok = self._tok_window
            if now - t0 >= 0.5:
                rolled = (ntok, self.serve_stats["tokens"])
                self._tok_window = [now, 0]
        if rolled is not None:   # counters emit outside _stats_lock
            tracer.counter("serve.tokens_per_s", rolled[0] / (now - t0))
            tracer.counter("serve.tokens_total", rolled[1])
        if self.paged:
            with self._stats_lock:
                shared = self._pages_shared
                tot = shared + self._pages_private
                chunks = self._chunks_total
            tracer.counter("serve.kv_pages_free", self.page_pool.pages_free)
            tracer.counter("serve.kv_page_hit_rate",
                           shared / tot if tot else 0.0)
            tracer.counter("serve.prefill_chunks", chunks)
        if self._store_mode:
            st = self.registry.stats
            tracer.counter("serve.adapter_cache_hits", st["cache_hits"])
            tracer.counter("serve.adapter_cache_misses", st["cache_misses"])
            tracer.counter("serve.adapter_cache_evictions",
                           st["cache_evictions"])
            tot = st["cache_hits"] + st["cache_misses"]
            tracer.counter("serve.adapter_miss_rate",
                           st["cache_misses"] / tot if tot else 0.0)

    def _dispatch(self, live):
        """One step call for the live slots: ``horizon`` batched steps, one
        read-back of the tokens, then delivery."""
        for i in live:
            self._toks[i] = self._slots[i].cur_tok
            self._poss[i] = self._slots[i].pos
        dev = self.device
        btabs = None
        if self.paged:
            # slots still prefilling see all-trash tables: their lanes'
            # writes at stale positions must not reach their wired pages
            bt = self._btabs
            prefilling = [i for i, s in enumerate(self._slots)
                          if s.prefilling]
            if prefilling:
                bt = bt.copy()
                bt[prefilling] = 0
            btabs = torch.as_tensor(bt, device=dev)
        gens = [s.gen if s.live else None for s in self._slots]
        toks = self._decode_step(
            self.raw_params, torch.as_tensor(self._aids, device=dev),
            self._pool if self.paged else self._caches, btabs,
            torch.as_tensor(self._toks, device=dev),
            torch.as_tensor(self._poss, device=dev), gens,
            [float(t) for t in self._temps])
        toks_host = toks.cpu().numpy()   # (n_slots, horizon)
        for i in live:
            for j in range(self.horizon):
                self._slots[i].pos += 1
                if not self._emit(i, int(toks_host[i, j])):
                    self._finish(i)
                    break




class SpeculativeBatchingEngine(ContinuousBatchingEngine):
    """Continuous batching × speculative decoding (greedy only).

    Every tick runs, for all slots at once, the draft's catch-up and
    ``k``-token proposal (:func:`~fedml_tpu_torch.serving.speculative
    .propose_block` at per-row starts), then one ``(k+1)``-token target
    verify (:func:`~fedml_tpu_torch.serving.speculative.verify_greedy_block`),
    so a slot advances up to ``k + 1`` tokens a tick and the target runs
    one block forward a tick whatever the acceptance.  The output is the
    plain engine's greedy stream (the draft changes only how many target
    forwards are spent).  The draft caches sit one row per slot.

    Verify and propose blocks write up to position ``buf_len + k``, so both
    models need ``max_seq_len >= buf_len + k + 1``: checked here, since the
    decode forward would clamp an overrunning write onto canonical K/V.
    ``params`` / ``draft_params``: ``None``, a ``{name: tensor}`` dict, or
    an int8 weight-only tree."""

    def __init__(self, model, params, draft_model, draft_params,
                 slots: int = 4, buf_len: int = 256, k: int = 4,
                 prefix_cache_slots: int = 0,
                 prefix_max_tail: int = TAIL_BLOCK,
                 hist_labels: int = 8,
                 slo_rules: Optional[List[Dict[str, Any]]] = None):
        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"k={k}: need >= 1")
        for m, name in ((model, "model"), (draft_model, "draft_model")):
            cfg = getattr(m, "cfg", None)
            if getattr(cfg, "kv_page_tokens", 0):
                raise PagedKVUnsupportedError(
                    f"{name} is built with kv_page_tokens="
                    f"{cfg.kv_page_tokens}: speculative decoding needs "
                    "contiguous per-slot caches; use ContinuousBatchingEngine "
                    "for paged serving, or a dense model here")
            msl = getattr(cfg, "max_seq_len", None)
            if msl is None:
                raise ValueError(
                    f"{name} has no cfg.max_seq_len: the speculative block "
                    "writes cannot be shown to stay in bounds")
            if msl < buf_len + self.k + 1:
                raise ValueError(
                    f"{name}.cfg.max_seq_len={msl} < buf_len+k+1="
                    f"{buf_len + self.k + 1}: speculative blocks would clamp "
                    "their cache writes")
        _check_params(draft_params)
        self.draft_model = draft_model
        self.raw_draft = draft_params
        self._pending_draft = None
        self._hist: Dict[int, List[int]] = {}
        self._fds = np.zeros(int(slots), np.int64)
        self._d_prefill, _, _ = _build_cached_decode(draft_model, 0, 1.0)
        dev = next(model.parameters()).device
        with torch.no_grad():
            self._d_caches = draft_model.init_cache(int(slots), dev,
                                                    page_tokens=0)
        #: target block forwards (one per live slot a tick), proposals
        #: examined and accepted
        self.stats = {"target_block_forwards": 0, "proposed": 0,
                      "accepted": 0}
        super().__init__(model, params, slots=slots, buf_len=buf_len,
                         top_k=0, horizon=1,
                         prefix_cache_slots=prefix_cache_slots,
                         prefix_max_tail=prefix_max_tail,
                         hist_labels=hist_labels, slo_rules=slo_rules)

    def update_params(self, params, draft_params=None, wait: bool = True,
                      timeout: float = 60.0) -> None:
        """Swap the target (and optionally the draft) weights after the
        in-flight drain.  A stale draft only lowers the acceptance rate, so
        the draft swap is optional."""
        if draft_params is not None:
            _check_params(draft_params)
            with self._cond:
                self._pending_draft = draft_params
        super().update_params(params, wait=wait, timeout=timeout)

    def _on_swap(self) -> None:
        if self._pending_draft is not None:
            self.raw_draft = self._pending_draft
            self._pending_draft = None

    def submit(self, prompt_ids, max_new_tokens: int = 64,
               temperature: float = 0.0, seed: int = 0, eos_id=None,
               adapter: Optional[str] = None,
               traceparent: Optional[str] = None):
        if float(temperature) != 0.0:
            raise ValueError("SpeculativeBatchingEngine is greedy-only "
                             "(temperature 0); use ContinuousBatchingEngine "
                             "for sampled requests")
        return super().submit(prompt_ids, max_new_tokens=max_new_tokens,
                              temperature=0.0, seed=seed, eos_id=eos_id,
                              adapter=adapter, traceparent=traceparent)

    def _admit(self, req, slot):
        self._hist[slot] = list(req["prompt_ids"])
        super()._admit(req, slot)   # the target's prefill and first token
        ids = req["prompt_ids"]
        n = len(ids)
        buf = torch.zeros((1, self.buf_len), dtype=torch.long,
                          device=self.device)
        buf[0, :n] = torch.tensor(ids, dtype=torch.long)
        _, dcache = self._d_prefill(self.raw_draft, None, buf, n, None, 0.0)
        self._d_caches.copy_rows_(slice(slot, slot + 1), dcache)
        self._fds[slot] = n

    def _emit(self, i: int, tok: int) -> bool:
        s = self._slots[i]
        before = s.remaining
        cont = super()._emit(i, tok)
        if s.remaining < before:   # the token was delivered
            self._hist[i].append(tok)
        return cont

    def _spec_tick(self, draw, raw, sync_bufs, sync_lens, fds, curs, poss):
        """The draft's propose block and the target's verify block over
        every slot: ``(d_tokens (slots, k), greedy (slots, k+1))``."""
        d_tokens, _ = propose_block(self.draft_model, draw, self._d_caches,
                                    sync_bufs, sync_lens, fds, self.k)
        blocks = torch.cat([curs[:, None], d_tokens], dim=1)
        greedy, _ = verify_greedy_block(self.model, raw, self._caches,
                                        blocks, poss)
        return d_tokens, greedy

    def _dispatch(self, live):
        kp1 = self.k + 1
        sync_bufs = np.zeros((self.n_slots, kp1), np.int64)
        sync_lens = np.ones(self.n_slots, np.int64)
        for i in live:
            s = self._slots[i]
            self._toks[i] = s.cur_tok
            self._poss[i] = s.pos
            sync_bufs[i] = sync_rows(self._hist[i], int(self._fds[i]), s.pos,
                                     kp1)
            sync_lens[i] = s.pos + 1 - int(self._fds[i])
        dev = self.device
        d_tokens, greedy = self._spec_tick(
            self.raw_draft, self.raw_params,
            torch.as_tensor(sync_bufs, device=dev),
            torch.as_tensor(sync_lens, device=dev),
            torch.as_tensor(self._fds, device=dev),
            torch.as_tensor(self._toks, device=dev),
            torch.as_tensor(self._poss, device=dev))
        d_host = d_tokens.cpu().numpy()
        g_host = greedy.cpu().numpy()
        self.stats["target_block_forwards"] += len(live)

        for i in live:
            s = self._slots[i]
            self._fds[i] = s.pos + 1   # the draft confirmed the old cur
            for j in range(self.k):
                # only the proposals examined count: eos or the budget can
                # end the acceptance loop mid-block
                self.stats["proposed"] += 1
                s.drafts_proposed += 1
                dj, gj = int(d_host[i, j]), int(g_host[i, j])
                s.pos += 1
                if dj != gj:
                    # first disagreement: the target's own token replaces it
                    if not self._emit(i, gj):
                        self._finish(i)
                    break
                self.stats["accepted"] += 1
                s.drafts_accepted += 1
                if not self._emit(i, dj):
                    self._finish(i)
                    break
            else:
                # every proposal accepted: the target's continuation token
                s.pos += 1
                if not self._emit(i, int(g_host[i, self.k])):
                    self._finish(i)

__all__ = ["ContinuousBatchingEngine", "PagedKVUnsupportedError",
           "SpeculativeBatchingEngine", "PageExhaustedError"]
