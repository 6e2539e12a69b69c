"""Event-driven client-arrival simulator (copy of
``fedml_tpu.simulation.async_sim``).

A virtual-clock event queue whose per-client completion latencies come
from the traffic distributions of ``core/traffic.py``:

- **latency**: log-normal (median ``latency_median_s``, shape
  ``latency_sigma``) per dispatch; at sigma 1.5 the p99/p50 ratio is ~33x,
  the cross-device straggler regime;
- **persistent stragglers**: an optional per-client speed multiplier
  (log-normal, keyed by client id), so the same registered ids are slow
  whenever they are sampled;
- **dropout**: a Bernoulli per dispatch: the update never arrives;
- **availability**: a Bernoulli "client was busy" draw adding an
  exponential wait before training starts.

Everything is deterministic in ``(seed, generation, lane)`` through
``core/hostrng.py``'s Philox streams, bitwise the JAX package's events.
The clock is virtual (simulated seconds); device compute runs as fast as
the host allows.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core import hostrng, traffic

#: hostrng purpose tags (disjoint from the engines' sampling/latency tags)
LATENCY_TAG = 0xA51A7
SPEED_TAG = 0xA55BD


@dataclass
class Arrival:
    """One completed (or lost) client update reaching the server."""
    time: float          # virtual arrival time (s)
    gen: int             # dispatch generation the client belongs to
    slot: int            # lane inside the generation's stacked outputs
    client: int          # registered client id
    version: int         # server model version at dispatch
    latency_s: float     # dispatch -> arrival (virtual)
    dropped: bool        # client dropped out; the update never lands


class ArrivalSimulator:
    """Virtual-clock event queue over per-client completion draws.

    ``dispatch(gen, version, clients, now)`` schedules one arrival per
    sampled client; ``next_arrival()`` pops them in virtual-time order
    (ties break on dispatch sequence, so zero-latency runs process a
    generation's arrivals in cohort order — the bitwise parity case).
    """

    def __init__(self, seed: int, latency_median_s: float = 1.0,
                 latency_sigma: float = 1.5, dropout: float = 0.0,
                 speed_sigma: float = 0.0, unavailable_p: float = 0.0,
                 unavailable_mean_s: float = 0.0):
        self.seed = int(seed)
        self.latency_median_s = float(latency_median_s)
        self.latency_sigma = float(latency_sigma)
        self.dropout = float(dropout)
        self.speed_sigma = float(speed_sigma)
        self.unavailable_p = float(unavailable_p)
        self.unavailable_mean_s = float(unavailable_mean_s)
        self.now = 0.0
        self._heap: List[tuple] = []
        self._seq = 0
        self._speed: dict = {}

    # -- draws -------------------------------------------------------------
    def client_speed(self, client: int) -> float:
        """Persistent slowness multiplier of one registered client id
        (log-normal, median 1; 1.0 exactly when speed_sigma == 0)."""
        if self.speed_sigma <= 0.0:
            return 1.0
        s = self._speed.get(int(client))
        if s is None:
            rng = hostrng.gen(self.seed, SPEED_TAG, int(client))
            s = float(rng.lognormal(0.0, self.speed_sigma))
            self._speed[int(client)] = s
        return s

    def draw_latencies(self, gen: int, clients) -> np.ndarray:
        """The generation's per-lane completion latencies (s) — pure in
        ``(seed, gen)``, so a sync and an async run can share draws."""
        n = len(clients)
        rng = hostrng.gen(self.seed, LATENCY_TAG, int(gen))
        if self.latency_median_s <= 0.0:
            lat = np.zeros(n)
        else:
            lat = traffic.lognormal_latencies(
                rng, self.latency_median_s, self.latency_sigma, n)
        lat = lat * np.asarray([self.client_speed(c) for c in clients])
        if self.unavailable_p > 0.0:
            busy = traffic.bernoulli(rng, self.unavailable_p, n)
            lat = lat + busy * rng.exponential(
                max(self.unavailable_mean_s, 1e-9), n)
        drop = traffic.bernoulli(rng, self.dropout, n)
        return lat, drop

    # -- the queue ---------------------------------------------------------
    def dispatch(self, gen: int, version: int, clients,
                 now: Optional[float] = None):
        """Schedule one arrival per sampled client of generation ``gen``,
        dispatched at virtual time ``now`` (default: the current clock)."""
        t0 = self.now if now is None else float(now)
        lat, drop = self.draw_latencies(gen, clients)
        for slot, c in enumerate(np.asarray(clients).tolist()):
            ev = Arrival(time=t0 + float(lat[slot]), gen=int(gen),
                         slot=slot, client=int(c), version=int(version),
                         latency_s=float(lat[slot]),
                         dropped=bool(drop[slot]))
            heapq.heappush(self._heap, (ev.time, self._seq, ev))
            self._seq += 1

    def next_arrival(self) -> Optional[Arrival]:
        """Pop the earliest arrival and advance the virtual clock."""
        if not self._heap:
            return None
        t, _seq, ev = heapq.heappop(self._heap)
        self.now = max(self.now, t)
        return ev

    def peek_next(self, n: int) -> List[Arrival]:
        """The next ``n`` arrivals in pop order WITHOUT consuming them
        (the engine's atomic-cohort fast-path probe)."""
        return [ev for _t, _s, ev in heapq.nsmallest(n, self._heap)]

    def pending(self) -> int:
        return len(self._heap)
