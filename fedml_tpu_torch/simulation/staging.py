"""Host cohort staging that overlaps device compute (port of
``fedml_tpu.simulation.staging``).

``AsyncCohortStager`` double-buffers the host-side cohort build (sampling,
batch-index materialization, padding): while the round or fused block
``r`` runs on the device, a single worker thread builds ``r+1`` so host
work overlaps device compute instead of serializing in front of every
launch.  The fused round-block loop (``args.round_block``) keys the
stager by the block's first round index.

The builds here return host numpy only; the worker thread never touches
CUDA.  The caller copies a staged block to the device on its own thread.
Every build runs under a fedtrace ``staging`` span, and the pending depth
is sampled as the ``staging.queue_depth`` counter (one attribute check
each when tracing is off).

``depth`` (``args.staging_depth``) sets how many future rounds stay in
flight: ``get(r, prefetch=nxt)`` schedules ``nxt, nxt+stride, ...`` up to
``depth`` pending builds (``stride`` is the round-block size for fused
loops, 1 otherwise; ``limit`` caps scheduling at the last real round).
``stats()`` reports prefetch hits, synchronous misses and worker restarts.

Failure semantics: a ``build`` exception on the worker thread re-raises at
the NEXT ``get()`` regardless of which round it was speculatively built
for, stale pending futures for already-passed rounds are dropped, and
``close()`` is idempotent (a closed stager degrades to synchronous builds
instead of raising on a shut-down executor).  After a delivered failure the
worker pool is torn down and rebuilt (counted in
``stats()["worker_restarts"]``) so a poisoned thread never serves the next
speculative build.

Thread discipline: ``_pending``/``_failed`` and the counters are shared
between the calling thread and the worker; every access holds ``_lock``,
while the builds themselves (``fut.result()``, the synchronous miss path)
run outside it so a slow build never blocks ``stats()`` or ``close()``.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

from ..obs import get_tracer


class AsyncCohortStager:
    """Double-buffered host cohort staging.

    ``build(round_idx)`` must be a pure function of the round index that
    returns the staged round inputs as host arrays."""

    def __init__(self, build, enabled: bool = True, depth: int = 1,
                 stride: int = 1, limit=None):
        self._build = build
        self._enabled = enabled
        self._depth = max(int(depth), 1)
        self._stride = max(int(stride), 1)
        self._limit = limit
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=1) if enabled else None
        self._pending = {}
        self._failed = None   # first uncollected worker-thread exception
        self._closed = False
        self._hits = 0
        self._misses = 0
        self._restarts = 0

    def _traced_build(self, round_idx: int):
        tr = get_tracer()
        if not tr.enabled:
            return self._build(round_idx)
        with tr.span("staging", cat="staging", round=round_idx):
            return self._build(round_idx)

    def _worker_build(self, round_idx: int):
        try:
            return self._traced_build(round_idx)
        except BaseException as e:  # surfaced via _failed at the next get()
            with self._lock:
                if self._failed is None:
                    self._failed = e
            raise

    def _restart_pool_locked(self):
        """Tear down and rebuild the worker after a delivered failure so a
        poisoned speculative build never serves the next round.  Every
        pending speculative future belonged to the old pool: cancel and
        drop them (the caller rebuilds those rounds synchronously) so a
        later ``get()`` never surfaces a bare ``CancelledError``.  Caller
        holds ``_lock``; shutdown(wait=False) never blocks under it."""
        if not self._enabled or self._closed:
            return
        for f in self._pending.values():
            f.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._restarts += 1

    def get(self, round_idx: int, prefetch=None):
        with self._lock:
            # a pending future for an already-passed round can never be
            # consumed: drop it so it neither leaks nor masks a failure
            for stale in [r for r in self._pending if r < round_idx]:
                self._pending.pop(stale).cancel()
            fut = self._pending.pop(round_idx, None)
            if self._failed is not None and fut is None:
                # a speculative build (possibly for a LATER round) already
                # failed: re-raise promptly instead of waiting until the
                # caller reaches that round
                err, self._failed = self._failed, None
                for f in self._pending.values():
                    f.cancel()
                self._pending.clear()
                self._restart_pool_locked()
                raise err
        if fut is not None:
            try:
                staged = fut.result()   # blocking wait happens off-lock
            except BaseException:
                # this failure is being delivered right here; don't
                # re-deliver it on the next get()
                with self._lock:
                    self._failed = None
                    self._restart_pool_locked()
                raise
            hit = True
        else:
            staged = self._traced_build(round_idx)
            hit = False
        with self._lock:
            if hit:
                self._hits += 1
            else:
                self._misses += 1
            if self._enabled and not self._closed and prefetch is not None:
                for i in range(self._depth):
                    nxt = prefetch + i * self._stride
                    if self._limit is not None and nxt >= self._limit:
                        break
                    if nxt not in self._pending:
                        self._pending[nxt] = self._pool.submit(
                            self._worker_build, nxt)
            depth = len(self._pending)
        tr = get_tracer()
        if tr.enabled:
            tr.counter("staging.queue_depth", depth)
        return staged

    def stats(self) -> dict:
        """Prefetch counters: ``hits`` (served from a speculative worker
        build), ``misses`` (built synchronously in front of the launch),
        ``worker_restarts`` (pool rebuilds after a delivered build
        failure), ``pending`` (builds in flight)."""
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "worker_restarts": self._restarts,
                    "pending": len(self._pending)}

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for f in self._pending.values():
                f.cancel()
            self._pending.clear()
            if self._pool is not None:
                self._pool.shutdown(wait=False, cancel_futures=True)
