"""FedBuffAPI: buffered-async federated aggregation (port of
``fedml_tpu.simulation.async_engine``; Nguyen et al., "Federated Learning
with Buffered Asynchronous Aggregation").

- Clients launch in **dispatch generations** (one staged cohort per
  generation, the sync engine's staging for that index) against a
  **versioned** ``ServerState``; a generation's client pass runs lazily
  against its dispatch-version state, so a fully dropped generation costs
  nothing.
- Each completed update lands, at its simulated arrival time, in a K-row
  device buffer with the staleness-discounted weight ``s(τ) = 1/(1+τ)^α``
  (τ: server versions since dispatch; ``core/federated.py``'s buffer
  algebra).  Updates staler than ``async_max_staleness`` and dropped
  clients never land.
- When K rows have landed the server finishes the buffer with the spec's
  stacked reductions and runs the unchanged server transition: one apply
  is one round of the inherited loop, so evaluation, records and
  checkpoints work as in the sync engine.

**Atomic-cohort fast path.**  When a whole fresh generation is about to
land in an empty buffer with zero staleness and K equal to the cohort, the
apply is exactly one synchronous round, and the driver runs the sync
engine's own round program on the generation's staged cohort: bitwise the
sync engine, one call instead of K buffer adds.

Arrivals come from ``simulation/async_sim.py``'s virtual clock
(heavy-tailed latency, persistent stragglers, dropout), bitwise the JAX
package's events.  Per-client algorithm state (SCAFFOLD, FedDyn) is
gathered at dispatch and written back at arrival, through the paged store
with ``client_store``.

``async_driver.py`` is the multi-rank twin of this engine over the
message plane and the wire codec.

The obs plane: ``async.dispatch`` and ``async.arrival`` spans and the
``async.*`` counters (buffer occupancy, staleness p50/p99, dropped
updates, simulated time) when tracing; under ``health`` each generation's
client pass adds the ``(C,)`` health lanes against the generation's
weighted-mean update, which land in the buffer like the loss lane, and an
apply reports them with the buffer's ``staleness`` lane and the host
slot→client map (``health_clients``).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from ..core import federated
from ..core import rng as rng_util
from ..core import tree as tree_util
from .async_sim import ArrivalSimulator
from .round_engine import draw_dropout
from .sp.fedavg_api import FedAvgAPI

log = logging.getLogger(__name__)


class _Generation:
    """One in-flight dispatch generation: its staged cohort, its
    dispatch-version state and, once an arrival needs them, the per-client
    update rows.  Kept until every arrival was consumed or dropped."""

    __slots__ = ("index", "state", "args", "cohort", "rows", "new_c",
                 "remaining", "version")

    def __init__(self, index, state, args, cohort, remaining, version):
        self.index = index
        self.state = state          # dispatch-version ServerState
        self.args = args            # (idx, mask, w, c_stacked)
        self.cohort = cohort
        self.rows = None
        self.new_c = None
        self.remaining = remaining
        self.version = version


class FedBuffAPI(FedAvgAPI):
    """The buffered-async driver over any registered algorithm spec:
    ``federated_optimizer: fedbuff`` selects it, ``async_base_optimizer``
    (default ``fedavg``) picks the spec and server transition.  Options:
    ``async_buffer_k`` (default the cohort size), ``async_alpha``,
    ``async_max_staleness``, ``async_inflight_gens``, ``async_fastpath``,
    and the simulator's ``async_latency_median_s``,
    ``async_latency_sigma``, ``async_dropout``, ``async_speed_sigma``,
    ``async_unavailable_p``, ``async_unavailable_mean_s``."""

    NAMES = ("fedbuff",)

    #: dispatches allowed without one apply before the driver declares the
    #: configuration unable to make progress (dropout ~ 1)
    MAX_DISPATCHES_PER_APPLY = 64

    def __init__(self, args, device, dataset, model,
                 client_mode: str = "vmap"):
        base = str(getattr(args, "async_base_optimizer", "") or "fedavg")
        if int(getattr(args, "round_block", 1) or 1) > 1:
            raise ValueError(
                "incompatible flags: fedbuff + round_block — applies are "
                "event-driven, there is no K-round lockstep to fuse")
        if bool(getattr(args, "cohort_bucketing", False)):
            raise ValueError(
                "incompatible flags: fedbuff + cohort_bucketing (the "
                "buffer is one fixed-shape virtual cohort)")
        super().__init__(args, device, dataset, model, client_mode,
                         algorithm=base)
        if self.collective_precision != "fp32":
            raise ValueError(
                "fedbuff buffers fp32 update rows; collective_precision "
                "must stay 'fp32'")
        if not hasattr(self, "_dev_x"):
            raise ValueError(
                "fedbuff needs the device-gather cohort path "
                "(device_data=True): generations ship index tensors")
        g = lambda k, d=0.0: getattr(args, k, d) or d
        self.buffer_k = int(g("async_buffer_k", 0)) or self.clients_per_round
        self.async_alpha = float(getattr(args, "async_alpha", 0.5))
        self.max_staleness = int(g("async_max_staleness", 0))
        self.inflight_gens = max(1, int(g("async_inflight_gens", 1)))
        self.fastpath = bool(getattr(args, "async_fastpath", True))
        self.sim = ArrivalSimulator(
            seed=self.seed,
            latency_median_s=float(g("async_latency_median_s")),
            latency_sigma=float(g("async_latency_sigma", 1.5)),
            dropout=float(g("async_dropout")),
            speed_sigma=float(g("async_speed_sigma")),
            unavailable_p=float(g("async_unavailable_p")),
            unavailable_mean_s=float(g("async_unavailable_mean_s")))
        self._program = federated.RoundProgram(
            self.server_opt.spec, self.trainer.make_local_train(),
            self.server_opt, client_mode)
        self.buffer = None           # made from the first rows
        self._gens: Dict[int, _Generation] = {}
        self._next_gen = 0
        self._version = 0
        self._occ_host = 0           # host mirror of the buffer occupancy
        self._staleness_window: list = []
        self.updates_dropped = 0
        self.clients_dispatched = 0
        self.updates_buffered = 0
        self.fastpath_applies = 0
        # slot -> client id of the landed rows (the health lanes' ids)
        self._slot_clients = np.zeros(self.buffer_k, np.int64)

    # -- the device programs -------------------------------------------------
    def _gen_key(self, g: int) -> torch.Generator:
        """Generation ``g``'s generator, the sync round ``g``'s (a fresh
        one at every use: drawing advances a generator)."""
        return rng_util.round_key(self._root, g)

    def _dispatch_rows(self, state, g: int, idx, mask, w, c_stacked):
        """One generation's client pass from its dispatch-version state:
        the spec's unreduced per-client rows, with the loss and step lanes,
        and the clients' new algorithm state."""
        idx = idx.to(torch.long)
        x, y = self._dev_x[idx], self._dev_y[idx]
        drop = draw_dropout(self.model, self._gen_key(g), idx.shape[:3])
        outs = self._program.run_clients(state, x, y, mask, drop, c_stacked)
        rows = federated.client_update_rows(self.server_opt.spec,
                                            self.server_opt, state, outs, w)
        # the metrics lanes ride the buffer: the apply's train_loss is the
        # staleness-weighted mean of the K landed losses
        rows["__loss"] = {"src": outs.loss, "w": w.to(torch.float32)}
        rows["__steps"] = {"src": outs.num_steps.to(torch.float32)}
        if self._health:
            # the lanes at dispatch, against the generation's own cohort
            # (no post-apply params exist yet); the staleness lane joins at
            # apply from the buffer's tau
            rows["__health"] = federated.client_health_stats(
                state.global_params, outs.params,
                federated.cohort_mean_delta(state.global_params,
                                            outs.params, w),
                outs.loss, w)
        return rows, outs.new_client_state

    def _apply_buffer(self):
        buf = self.buffer
        self.state, _, fresh = federated.update_buffer_apply(
            self.server_opt.spec, self.server_opt, self.state, buf)
        e = buf["rows"]["__loss"]
        eff = buf["s"] * e["w"]
        metrics = {
            "train_loss": torch.sum(e["src"] * eff)
            / torch.clamp(torch.sum(eff), min=1e-12),
            "total_steps": torch.sum(buf["rows"]["__steps"]["src"]),
            "staleness_mean": torch.sum(buf["tau"])
            / torch.clamp(buf["occupancy"], min=1.0),
            "staleness_max": torch.max(buf["tau"]),
            "buffer_occupancy": buf["occupancy"],
            "model_version": buf["version"],
        }
        if self._health:
            metrics["health"] = dict(buf["rows"]["__health"],
                                     staleness=buf["tau"])
            metrics["health_clients"] = self._slot_clients.copy()
        self.buffer = fresh
        return metrics

    # -- dispatch and arrival ------------------------------------------------
    def _dispatch_generation(self):
        g = self._next_gen
        self._next_gen += 1
        with self._tracer.span("async.dispatch", cat="round", gen=g,
                               version=self._version):
            clients, idx, mask, w, _steps = self._stage_round_arrays(g)
            cohort = np.asarray(clients, dtype=np.int64)
            # the per-client state as of dispatch (what the client trains
            # from)
            c_stacked = self._gather_c(cohort, g)
            args = (*self._to_device(idx, mask, w), c_stacked)
        self._gens[g] = _Generation(g, self.state, args, cohort, len(cohort),
                                    self._version)
        self.sim.dispatch(g, self._version, clients)
        self.clients_dispatched += len(cohort)
        return g

    def _maybe_dispatch(self):
        while len(self._gens) < self.inflight_gens:
            self._dispatch_generation()

    def _ensure_rows(self, gen: _Generation):
        """The generation's client pass, once, against its dispatch
        state."""
        if gen.rows is None:
            idx, mask, w, c_stacked = gen.args
            gen.rows, gen.new_c = self._dispatch_rows(
                gen.state, gen.index, idx, mask, w, c_stacked)
            if self.buffer is None:
                self.buffer = federated.update_buffer_zeros(
                    self.server_opt.spec, gen.rows, self.buffer_k)
                self.buffer["version"] += float(self._version)
        return gen.rows

    def _writeback_arrival(self, gen: _Generation, ev):
        """Write one client's new algorithm state back, in arrival order:
        through the store's pager, or into the dense table."""
        if gen.new_c is None:
            return
        row = {k: v[ev.slot:ev.slot + 1] for k, v in gen.new_c.items()}
        ids = np.asarray([ev.client], np.int64)
        if self._pager is not None:
            self._pager.write_back(self._version, ids, row)
        elif self.client_table is not None:
            self.client_table = tree_util.cohort_scatter(
                self.client_table, ids, row)

    def _process_arrival(self, ev) -> bool:
        """Land one arrival in the buffer, or drop it; True when a row
        landed."""
        gen = self._gens[ev.gen]
        gen.remaining -= 1
        try:
            tau = self._version - ev.version
            if ev.dropped or (self.max_staleness
                              and tau > self.max_staleness):
                self.updates_dropped += 1
                return False
            self._ensure_rows(gen)
            with self._tracer.span("async.arrival", cat="round",
                                   client=ev.client, staleness=tau,
                                   latency_s=round(ev.latency_s, 6)):
                self.buffer = federated.update_buffer_add(
                    self.buffer, gen.rows, [ev.slot], [self._occ_host],
                    [float((1.0 + tau) ** (-self.async_alpha))],
                    [float(tau)])
            self._slot_clients[self._occ_host] = ev.client
            self._occ_host += 1
            self.updates_buffered += 1
            self._staleness_window.append(tau)
            self._writeback_arrival(gen, ev)
            return True
        finally:
            if gen.remaining <= 0:
                del self._gens[ev.gen]

    # -- the atomic-cohort fast path -------------------------------------------
    def _atomic_cohort(self, ev) -> Optional[_Generation]:
        """The popped arrival and the next K-1 queued ones are exactly one
        untouched, zero-staleness generation filling the empty buffer: the
        apply is then one synchronous round of that generation."""
        if not self.fastpath or self._occ_host != 0:
            return None
        gen = self._gens.get(ev.gen)
        if gen is None or gen.rows is not None:
            return None
        k = self.buffer_k
        if gen.version != self._version or len(gen.cohort) != k:
            return None
        if ev.dropped or ev.slot != 0 or gen.remaining != k:
            return None
        nxt = self.sim.peek_next(k - 1)
        if len(nxt) != k - 1:
            return None
        if any(e.gen != ev.gen or e.dropped for e in nxt) \
                or sorted(e.slot for e in nxt) != list(range(1, k)):
            return None
        return gen

    def _apply_fastpath(self, gen: _Generation, ev):
        """Consume the generation's arrivals and run the sync round program
        on its staged cohort."""
        for _ in range(self.buffer_k - 1):
            e2 = self.sim.next_arrival()
            assert e2 is not None and e2.gen == ev.gen
        idx, mask, w, c_stacked = gen.args
        self.state, metrics, new_c = self.round_fn(
            self.state, idx, mask, w, self._gen_key(gen.index), c_stacked)
        self._scatter_c(gen.cohort, new_c, self._version)
        del self._gens[ev.gen]
        self.updates_buffered += self.buffer_k
        self._staleness_window.extend([0] * self.buffer_k)
        self.fastpath_applies += 1
        metrics = dict(metrics)
        metrics.update(staleness_mean=0.0, staleness_max=0.0,
                       buffer_occupancy=float(self.buffer_k),
                       model_version=float(self._version))
        if self._health and metrics.get("health") is not None:
            # the sync round's lanes are in cohort order, with zero
            # staleness by construction
            metrics["health"] = dict(
                metrics["health"],
                staleness=np.zeros(self.buffer_k, np.float32))
            metrics["health_clients"] = np.asarray(gen.cohort, np.int64)
        return metrics

    # -- the driver round ------------------------------------------------------
    def train_one_round(self, round_idx: int):
        """Advance the event loop until one buffer apply happens; the
        inherited ``train()`` drives this as a synchronous round."""
        dispatches_at_entry = self._next_gen
        metrics = None
        while metrics is None:
            self._maybe_dispatch()
            ev = self.sim.next_arrival()
            if ev is None:
                if self._next_gen - dispatches_at_entry > \
                        self.MAX_DISPATCHES_PER_APPLY:
                    raise RuntimeError(
                        "fedbuff cannot fill its buffer (every arrival "
                        "dropped?); check async_dropout/async_max_"
                        "staleness")
                continue
            gen = self._atomic_cohort(ev)
            if gen is not None:
                metrics = self._apply_fastpath(gen, ev)
                break
            self._process_arrival(ev)
            if self._occ_host >= self.buffer_k:
                metrics = self._apply_buffer()
                self._occ_host = 0
        self._version += 1
        metrics = dict(metrics)
        window = self._staleness_window
        self._staleness_window = []
        p50 = float(np.percentile(window, 50)) if window else 0.0
        p99 = float(np.percentile(window, 99)) if window else 0.0
        if self._tracer.enabled:
            self._tracer.counter("async.buffer_occupancy", self.buffer_k)
            self._tracer.counter("async.staleness_p50", p50)
            self._tracer.counter("async.staleness_p99", p99)
            self._tracer.counter("async.updates_dropped",
                                 self.updates_dropped)
            self._tracer.counter("async.sim_time_s", round(self.sim.now, 6))
        metrics.update(
            allocated_steps=self.buffer_k,
            staleness_p50=p50, staleness_p99=p99,
            sim_time_s=self.sim.now,
            updates_dropped=self.updates_dropped,
            clients_dispatched=self.clients_dispatched)
        return metrics

    def maybe_resume(self) -> int:
        """A resume restarts the async plane at the restored version with
        an empty buffer and nothing in flight (in-flight updates are not
        checkpointed state: they dispatch again)."""
        start = super().maybe_resume()
        if start:
            self._version = start
            self._next_gen = start
            if self.buffer is not None:
                self.buffer = federated._tmap(torch.zeros_like, self.buffer)
                self.buffer["version"] += float(start)
            self._occ_host = 0
            self._gens.clear()
        return start
