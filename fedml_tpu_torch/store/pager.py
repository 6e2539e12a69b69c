"""CohortStatePager: store paging overlapped with device compute (port of
``fedml_tpu.store.pager``).

What makes the store-backed round bitwise the dense one:

- **Page-in is speculative, value reads are not.**  The pager's
  :class:`~fedml_tpu_torch.simulation.staging.AsyncCohortStager` build for
  round ``r+1`` only makes pages resident (disk load or zero pages, the
  expensive part); the row values are read at ``gather(r+1)``, after round
  ``r``'s write-back has been applied, so a speculative page-in never
  serves stale rows however cohorts overlap.
- **Write-back is asynchronous but ordered.**  ``write_back`` starts the
  device-to-host copy of the round's rows on the stream that produced
  them, into pinned host memory, and records a CUDA event after it; a
  single writer thread waits for that event, then scatters into the store.
  The copy is queued behind the round's kernels and ahead of anything the
  caller later launches on that stream (a replayed CUDA graph reusing the
  output buffers included), and the host never blocks on the round.
  ``gather`` drains pending write-backs first, so reads see every
  completed round.

``store.page_hit_rate`` (stager prefetch hits over builds) and
``store.writeback_lag_rounds`` (write-backs still pending at gather time)
ride the fedtrace counter plane beside the store's ``store.page_in_bytes``;
``stats()`` carries the stager's hits and misses.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..core.tree import host_copy_tree
from ..obs import get_tracer
from ..simulation.staging import AsyncCohortStager
from .clientstore import ClientStateStore


class CohortStatePager:
    """Double-buffered page-in and deferred write-back for a
    :class:`ClientStateStore`.

    ``cohort_ids_fn(round_idx)`` must be a pure function of the round index
    returning the ids whose state that round touches (for a fused block:
    the union of the block's cohorts), so the page-in may run ahead on the
    worker thread."""

    def __init__(self, store: ClientStateStore,
                 cohort_ids_fn: Callable[[int], np.ndarray],
                 depth: int = 1, stride: int = 1,
                 limit: Optional[int] = None, enabled: bool = True):
        self.store = store
        self._cohort_ids_fn = cohort_ids_fn
        self._stager = AsyncCohortStager(self._page_in, enabled=enabled,
                                         depth=depth, stride=stride,
                                         limit=limit)
        self._writer = ThreadPoolExecutor(max_workers=1)
        self._pending_wb = deque()   # (round_idx, future)
        self._wb_lock = threading.Lock()
        self._closed = False

    def _page_in(self, round_idx: int):
        return self.store.page_in(self._cohort_ids_fn(round_idx))

    # -- round-facing API --------------------------------------------------
    def gather(self, round_idx: int, ids,
               prefetch: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Cohort-stacked host rows for ``ids``, with round
        ``round_idx``'s pages resident (prefetched, else paged in now) and
        every pending write-back applied first."""
        lag = self.drain_writebacks()
        self._stager.get(round_idx, prefetch=prefetch)
        rows = self.store.gather(ids)
        tr = get_tracer()
        if tr.enabled:
            st = self._stager.stats()
            total = st["hits"] + st["misses"]
            tr.counter("store.page_hit_rate",
                       st["hits"] / total if total else 0.0)
            tr.counter("store.writeback_lag_rounds", lag)
        return rows

    def write_back(self, round_idx: int, ids, new_rows: Mapping):
        """Queue the round's updated rows (tensors on any device, or
        arrays) for asynchronous write-back (module docstring)."""
        ids = np.asarray(ids, np.int64)
        staged, done = host_copy_tree(dict(new_rows))

        def apply():
            if done is not None:
                done.synchronize()
            self.store.scatter(ids, staged)

        with self._wb_lock:
            if self._closed:
                apply()
                return
            self._pending_wb.append((round_idx, self._writer.submit(apply)))

    def drain_writebacks(self) -> int:
        """Apply every queued write-back (re-raising the first failure);
        returns how many were still pending: the write-back lag."""
        with self._wb_lock:
            pending = list(self._pending_wb)
            self._pending_wb.clear()
        lag = sum(1 for _, f in pending if not f.done())
        for _, f in pending:
            f.result()
        return lag

    def stats(self) -> dict:
        s = self.store.stats()
        s.update({f"stager_{k}": v for k, v in self._stager.stats().items()})
        with self._wb_lock:
            s["writebacks_pending"] = len(self._pending_wb)
        return s

    def close(self):
        self.drain_writebacks()
        with self._wb_lock:
            self._closed = True
        self._stager.close()
        self._writer.shutdown(wait=True)


class AsyncRowFetcher:
    """Single-worker keyed fetch with a completion callback, the paged
    half of the serving adapter cache (``serving/adapters.py``): a miss
    calls ``request(name, fn)`` and requeues; the worker runs the (possibly
    disk-backed) store read off the engine thread, keeps the result for
    :meth:`take` and calls ``on_done`` so the engine wakes.

    A key already in flight is not fetched twice.  A fetch that raises
    keeps the exception instead: :meth:`take` re-raises it on the caller.
    """

    def __init__(self, on_done: Optional[Callable[[str], None]] = None):
        self._worker = ThreadPoolExecutor(max_workers=1)
        self._lock = threading.Lock()
        self._inflight: set = set()
        self._ready: dict = {}
        self.on_done = on_done
        self._closed = False

    def request(self, key: str, fn: Callable[[], Any]) -> bool:
        """Start fetching ``key`` with ``fn()`` unless it is in flight or
        ready; True when a new fetch started."""
        with self._lock:
            if self._closed or key in self._inflight or key in self._ready:
                return False
            self._inflight.add(key)

        def run():
            try:
                val, err = fn(), None
            except Exception as e:  # noqa: BLE001 — kept, re-raised on
                val, err = None, e  # the consumer in take()
            with self._lock:
                self._inflight.discard(key)
                if not self._closed:
                    self._ready[key] = (val, err)
            cb = self.on_done
            if cb is not None:
                cb(key)

        self._worker.submit(run)
        return True

    def take(self, key: str):
        """Pop a completed fetch: ``(True, value)`` when ready (re-raising a
        kept error), ``(False, None)`` while in flight or never asked."""
        with self._lock:
            if key not in self._ready:
                return False, None
            val, err = self._ready.pop(key)
        if err is not None:
            raise err
        return True, val

    def close(self):
        with self._lock:
            self._closed = True
            self._ready.clear()
        self._worker.shutdown(wait=True)
