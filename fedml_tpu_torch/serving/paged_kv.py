"""Host-side bookkeeping for the paged KV cache (port of
``fedml_tpu.serving.paged_kv``, a copy: the module is pure Python).

The device side is one page pool per layer (``llm/model.py``
``_DecodeCtx``) addressed through per-slot block tables
passed to each step as data.  Everything here is plain-python free-list +
refcount bookkeeping over *page ids*, no tensors, run only on the engine
thread between steps.

Page 0 is the reserved trash page: block tables default to it, so writes
past a slot's reservation (chunk padding, horizon burn-out) land in
garbage that mask discipline keeps out of every softmax.  It is never in
the free list and never refcounted.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple


class PageExhaustedError(RuntimeError):
    """Not enough free pages for a reservation (the engine parks the
    request and retries after the next finish/evict frees pages)."""


class PagedBlockPool:
    """Free list + per-page refcounts over ``n_pages`` device pages.

    Pages are *reserved* (refcount 1) at admission for a slot's private
    blocks, *shared* (refcount +1) when a prefix-cache hit lends its
    pages to a new slot or the cache itself retains them, and *released*
    when a holder drops out — a page returns to the free list when its
    last holder releases it.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"n_pages={n_pages}: page 0 is the reserved "
                             "trash page — need at least 2")
        self.n_pages = int(n_pages)
        self._free: List[int] = list(range(1, self.n_pages))
        self._refs = [0] * self.n_pages
        self.stats: Dict[str, int] = {
            "reserved_pages": 0, "shared_pages": 0, "released_pages": 0,
            "exhausted": 0,
        }

    @property
    def pages_free(self) -> int:
        return len(self._free)

    def can_reserve(self, n: int) -> bool:
        return n <= len(self._free)

    def reserve(self, n: int) -> List[int]:
        """Take ``n`` fresh pages (refcount 1 each) off the free list."""
        if n > len(self._free):
            self.stats["exhausted"] += 1
            raise PageExhaustedError(
                f"need {n} pages, {len(self._free)} free "
                f"(pool of {self.n_pages})")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.stats["reserved_pages"] += n
        return pages

    def share(self, pages: List[int]) -> None:
        """Add one holder to already-live pages (prefix sharing)."""
        for p in pages:
            if self._refs[p] <= 0:
                raise ValueError(f"share of dead page {p}")
            self._refs[p] += 1
        self.stats["shared_pages"] += len(pages)

    def release(self, pages: List[int]) -> None:
        """Drop one holder from each page; last holder frees it."""
        for p in pages:
            if p == 0:
                continue
            r = self._refs[p] - 1
            if r < 0:
                raise ValueError(f"release of free page {p}")
            self._refs[p] = r
            if r == 0:
                self._free.append(p)
        self.stats["released_pages"] += len(pages)


class PagedPrefixCache:
    """Prefix reuse as copy-on-write page *sharing* (refcounts), not KV
    copies — the paged counterpart of ``openai_compat.PrefixCache``.

    An entry holds the page ids covering the FULL pages of a finished
    prefill (positions ``[0, len(pages)*page_tokens)``); the cache itself
    holds one reference on each (``pool.share`` at insert).  ``lookup``
    lends the longest usable full-page prefix to a new slot — the caller
    increfs before wiring the pages into its block table, and the replay
    invariant (writes only at positions ``>= full*page_tokens``) keeps
    the lent pages read-only under every sharer.

    Entries are keyed by the prompt token tuple and pinned to the params
    identity + per-registration adapter token that produced them (KV
    computed under one weight/adapter version never serves another).
    """

    def __init__(self, capacity: int, page_tokens: int,
                 pool: PagedBlockPool):
        self.capacity = int(capacity)
        self.page_tokens = int(page_tokens)
        self.pool = pool
        self._entries: "OrderedDict[tuple, Tuple[List[int], Any]]" = \
            OrderedDict()
        self._params_ref: Any = None
        self.lock = threading.RLock()
        self.stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "insertions": 0, "evictions": 0,
            "shared_pages": 0, "private_pages": 0,
        }

    def _flush_if_stale(self, params) -> None:
        if self._params_ref is not params:
            self.clear()
            self._params_ref = params

    def clear(self) -> None:
        with self.lock:
            for pages, _tok in self._entries.values():
                self.pool.release(pages)
            self._entries.clear()

    def lookup(self, prompt_ids: List[int], params,
               adapter_token) -> Tuple[int, List[int]]:
        """Longest shareable full-page prefix for ``prompt_ids`` →
        ``(n_full_pages, page_ids)`` (``(0, [])`` on miss).  The shared
        span always leaves at least the final prompt token to replay, so
        the caller's chunk replay produces the first sample itself."""
        n = len(prompt_ids)
        ptok = self.page_tokens
        with self.lock:
            self._flush_if_stale(params)
            best: Tuple[int, List[int]] = (0, [])
            best_key = None
            for key, (pages, tok) in self._entries.items():
                if tok is not adapter_token:
                    continue
                c = 0
                for a, b in zip(key, prompt_ids):
                    if a != b:
                        break
                    c += 1
                full = min(len(pages), c // ptok, (n - 1) // ptok)
                if full > best[0]:
                    best = (full, pages[:full])
                    best_key = key
            if best_key is not None:
                self._entries.move_to_end(best_key)
                self.stats["hits"] += 1
                self.stats["shared_pages"] += best[0]
            else:
                self.stats["misses"] += 1
            return best

    def insert(self, prompt_ids: List[int], pages: List[int], params,
               adapter_token) -> None:
        """Retain ``pages`` (the prompt's full pages, in block order) for
        future sharers; the cache increfs them itself."""
        if not pages:
            return
        key = tuple(prompt_ids)
        with self.lock:
            self._flush_if_stale(params)
            if key in self._entries:
                self._entries.move_to_end(key)
                return
            self.pool.share(pages)
            self._entries[key] = (list(pages), adapter_token)
            self.stats["insertions"] += 1
            while len(self._entries) > self.capacity:
                _k, (old, _t) = self._entries.popitem(last=False)
                self.pool.release(old)
                self.stats["evictions"] += 1

    def evict_for_pages(self, needed_free: int) -> int:
        """LRU-drop entries until the pool could satisfy a reservation of
        ``needed_free`` pages (an entry's pages only return to the free
        list if no slot still shares them).  Returns entries dropped."""
        dropped = 0
        with self.lock:
            while self._entries and self.pool.pages_free < needed_free:
                _k, (pages, _t) = self._entries.popitem(last=False)
                self.pool.release(pages)
                self.stats["evictions"] += 1
                dropped += 1
        return dropped

    def __len__(self) -> int:
        with self.lock:
            return len(self._entries)
