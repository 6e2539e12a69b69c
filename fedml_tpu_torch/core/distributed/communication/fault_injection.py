"""Message-layer fault injection — chaos testing for the WAN federation
FSMs.

SURVEY §5 records that the reference has NO infra-fault injection anywhere
(its only "failure testing" is adversarial attacks); its FSMs were never
exercised under duplicated, delayed, or dropped messages.  This wrapper
decorates any ``BaseCommunicationManager`` with seeded, reproducible chaos
on the SEND side:

- **duplicate**: the message is delivered twice (broker QoS-1 semantics,
  retry storms);
- **delay**: delivery is deferred by a random interval on a timer thread,
  which also *reorders* messages relative to later sends (WAN jitter);
- **drop**: the message is silently discarded (connection loss) — gated by
  a ``droppable`` predicate so tests can protect messages whose loss is
  designed to be survivable only via timeouts.

Enable on any federation with flat args (read in ``create_comm_backend``)::

    chaos_seed: 7
    chaos_dup_prob: 0.3
    chaos_delay_prob: 0.5
    chaos_max_delay_s: 0.05
    chaos_drop_prob: 0.0

The cross-silo FSM is expected to survive dup+delay chaos unmodified
(stale-round guards + idempotent aggregation) — ``tests/test_chaos.py``.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

from .base_com_manager import BaseCommunicationManager, Observer
from .message import Message

log = logging.getLogger(__name__)


class SiloCrashed(RuntimeError):
    """In-thread stand-in for a process crash (``chaos_crash_mode=
    "raise"``): the driver thread dies where ``os._exit`` would have
    killed the process."""


def maybe_crash_at_round(args, rank: int, round_idx: int):
    """crash-at-round chaos: kill ``chaos_crash_rank`` the moment it
    reaches round ``chaos_crash_round``.  Deterministic by construction
    (no RNG — the schedule IS the spec).  Mode ``exit`` is a true crash
    (``os._exit`` — no finally blocks, no flushes, exactly what a
    SIGKILL leaves behind); ``raise`` throws :class:`SiloCrashed` for
    in-thread chaos tests where os._exit would kill the pytest process."""
    if int(getattr(args, "chaos_crash_rank", -1)) != int(rank):
        return
    if int(getattr(args, "chaos_crash_round", -1)) != int(round_idx):
        return
    mode = str(getattr(args, "chaos_crash_mode", "exit"))
    log.warning("chaos: CRASHING rank %d at round %d (mode=%s)", rank,
                round_idx, mode)
    if mode == "raise":
        raise SiloCrashed(f"rank {rank} crashed at round {round_idx}")
    os._exit(3)


@dataclass(frozen=True)
class PartitionSpec:
    """One directional partition window ``src>dst:lo-hi`` (rounds,
    inclusive): messages from ``src`` to ``dst`` whose ``round_idx``
    falls in the window are dropped.  Round-less transport messages
    (acks, heartbeats) in the same direction are dropped while the
    sender's round CURSOR (the highest round_idx it has sent) sits in
    the window — so a partitioned silo's lease expires and heals with
    the partition, deterministically in round space."""
    src: int
    dst: int
    lo: int
    hi: int

    @classmethod
    def parse(cls, spec: str) -> "PartitionSpec":
        try:
            edge, window = str(spec).split(":")
            src, dst = edge.split(">")
            lo, hi = window.split("-")
            return cls(int(src), int(dst), int(lo), int(hi))
        except ValueError as e:
            raise ValueError(
                f"bad chaos_partition spec {spec!r} — want "
                "'src>dst:round_lo-round_hi'") from e

    def blocks(self, sender: int, receiver: int,
               round_idx: Optional[int]) -> bool:
        if (sender, receiver) != (self.src, self.dst):
            return False
        if round_idx is None:
            return False
        return self.lo <= int(round_idx) <= self.hi


def parse_partitions(specs) -> List[PartitionSpec]:
    if not specs:
        return []
    if isinstance(specs, str):
        specs = [s for s in specs.split(",") if s.strip()]
    return [PartitionSpec.parse(s) for s in specs]


class FaultInjectingCommManager(BaseCommunicationManager):
    def __init__(self, inner: BaseCommunicationManager, seed: int = 0,
                 dup_prob: float = 0.0, delay_prob: float = 0.0,
                 max_delay_s: float = 0.05, drop_prob: float = 0.0,
                 droppable: Optional[Callable[[Message], bool]] = None,
                 partitions: Sequence[PartitionSpec] = (),
                 bandwidth_bps: float = 0.0):
        self.inner = inner
        self._rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()
        self.dup_prob = float(dup_prob)
        self.delay_prob = float(delay_prob)
        self.max_delay_s = float(max_delay_s)
        self.drop_prob = float(drop_prob)
        self.droppable = droppable or (lambda msg: True)
        self.partitions = list(partitions)
        self.bandwidth_bps = float(bandwidth_bps)
        self.stats = {"sent": 0, "dropped": 0, "duplicated": 0,
                      "delayed": 0, "partitioned": 0, "bw_delayed": 0}
        self._timers: list = []  # (timer, msg, entry) triples
        self._pending_lock = threading.Lock()
        self._round_cursor = -1          # highest round_idx sent
        self._link_free_at: dict = {}    # (src, dst) -> monotonic time

    def _draw(self):
        with self._rng_lock:
            return self._rng.random(3)

    def _bump(self, key: str):
        with self._rng_lock:  # stats share the rng lock (both are send-path)
            self.stats[key] += 1

    def _emit_drop_span(self, msg: Message, reason: str):
        # surface the drop on the trace plane: a dropped message never
        # reaches the backend, so no comm.send span exists — without
        # this marker the loss is invisible to `fedproto check-trace`
        from ....obs import context as obs_context
        from ....obs import get_tracer
        tracer = get_tracer()
        if tracer.enabled:
            with tracer.span("comm.drop", cat="comm",
                             msg_type=str(msg.get_type()),
                             dst=msg.get_receiver_id(), reason=reason,
                             msg_id=msg.get(obs_context.KEY_MSG_ID)):
                pass

    def _partitioned(self, msg: Message) -> bool:
        if not self.partitions:
            return False
        try:
            s, r = msg.get_sender_id(), msg.get_receiver_id()
        except (KeyError, TypeError, ValueError):
            return False
        rnd = msg.get("round_idx")
        with self._rng_lock:
            if rnd is not None:
                self._round_cursor = max(self._round_cursor, int(rnd))
            cursor = self._round_cursor
        probe = int(rnd) if rnd is not None else (cursor if cursor >= 0
                                                  else None)
        return any(p.blocks(s, r, probe) for p in self.partitions)

    def _payload_nbytes(self, msg: Message) -> int:
        n = 256  # control-dict floor
        for v in msg.get_params().values():
            if isinstance(v, np.ndarray):
                n += v.nbytes
            elif isinstance(v, bytes):
                n += len(v)
            elif isinstance(v, dict):
                for leaf in _iter_leaves(v):
                    if isinstance(leaf, np.ndarray):
                        n += leaf.nbytes
        return n

    def send_message(self, msg: Message):
        p_drop, p_dup, p_delay = self._draw()
        self._bump("sent")
        if self._partitioned(msg):
            self._bump("partitioned")
            log.info("chaos: PARTITION dropping msg type=%s %s->%s "
                     "round=%s", msg.get_type(), msg.get_sender_id(),
                     msg.get_receiver_id(), msg.get("round_idx"))
            self._emit_drop_span(msg, "partition")
            return
        if p_drop < self.drop_prob and self.droppable(msg):
            self._bump("dropped")
            log.info("chaos: DROPPING msg type=%s %s->%s",
                     msg.get_type(), msg.get_sender_id(),
                     msg.get_receiver_id())
            self._emit_drop_span(msg, "drop")
            return
        copies = 1
        if p_dup < self.dup_prob:
            copies = 2
            self._bump("duplicated")
        delayed = p_delay < self.delay_prob and self.max_delay_s > 0
        if delayed:
            self._bump("delayed")  # per message, like the other stats
        bw_delay = 0.0
        if self.bandwidth_bps > 0:
            # modeled serial link per (src, dst) edge: delivery waits for
            # the link to drain earlier payloads, then pays its own
            # transmit time — deterministic given the payload sizes
            import time as _time
            tx = self._payload_nbytes(msg) * 8.0 / self.bandwidth_bps
            edge = (msg.get_sender_id(), msg.get_receiver_id())
            now = _time.monotonic()
            with self._rng_lock:
                free = max(self._link_free_at.get(edge, now), now) + tx
                self._link_free_at[edge] = free
            bw_delay = free - now
            if bw_delay > 0:
                self._bump("bw_delayed")
        for _ in range(copies):
            if delayed or bw_delay > 0:
                delay = bw_delay
                if delayed:
                    with self._rng_lock:
                        delay += float(self._rng.random()) * self.max_delay_s
                entry = {"done": False}
                t = threading.Timer(delay, self._deliver_once, (msg, entry))
                t.daemon = True
                t.start()
                with self._pending_lock:
                    # prune delivered entries so long soaks don't pin every
                    # delayed payload (model weights) for the manager's life
                    self._timers = [e for e in self._timers
                                    if not e[2]["done"]]
                    self._timers.append((t, msg, entry))
            else:
                self.inner.send_message(msg)

    def _deliver_once(self, msg: Message, entry: dict):
        with self._pending_lock:
            if entry["done"]:
                return
            entry["done"] = True
        self.inner.send_message(msg)

    # -- pure delegation ---------------------------------------------------
    def add_observer(self, observer: Observer):
        self.inner.add_observer(observer)

    def remove_observer(self, observer: Observer):
        self.inner.remove_observer(observer)

    def handle_receive_message(self):
        self.inner.handle_receive_message()

    def stop_receive_message(self):
        # FLUSH (not cancel) in-flight delayed messages: a sender that
        # stops right after its final send (the server's FINISH broadcast)
        # must not un-send what chaos merely deferred
        with self._pending_lock:
            pending = list(self._timers)
            self._timers = []
        for t, msg, entry in pending:
            t.cancel()
            self._deliver_once(msg, entry)
        self.inner.stop_receive_message()


def _iter_leaves(d):
    for v in d.values():
        if isinstance(v, dict):
            yield from _iter_leaves(v)
        else:
            yield v


def maybe_wrap_with_chaos(manager: BaseCommunicationManager, args, rank: int
                          ) -> BaseCommunicationManager:
    """args-gated decoration (called from ``create_comm_backend``)."""
    dup = float(getattr(args, "chaos_dup_prob", 0.0) or 0.0)
    delay = float(getattr(args, "chaos_delay_prob", 0.0) or 0.0)
    drop = float(getattr(args, "chaos_drop_prob", 0.0) or 0.0)
    partitions = parse_partitions(getattr(args, "chaos_partition", None))
    bw = float(getattr(args, "chaos_bandwidth_bps", 0.0) or 0.0)
    if not (dup or delay or drop or partitions or bw):
        return manager
    seed = int(getattr(args, "chaos_seed", 0)) * 1000 + rank
    droppable = None
    types = getattr(args, "chaos_droppable_types", None)
    if types:
        # str-normalized: Message.get_type() is an int for the FSM
        # protocols but a flow-name string under the Flow DSL.  Only these
        # types may be dropped — losing an INIT/FINISH control message
        # deadlocks by design (no retry path exists for them in the
        # reference protocol either)
        allowed = {str(t) for t in types}
        droppable = lambda m: str(m.get_type()) in allowed  # noqa: E731
    return FaultInjectingCommManager(
        manager, seed=seed, dup_prob=dup, delay_prob=delay,
        max_delay_s=float(getattr(args, "chaos_max_delay_s", 0.05)),
        drop_prob=drop, droppable=droppable, partitions=partitions,
        bandwidth_bps=bw)


__all__ = ["FaultInjectingCommManager", "maybe_wrap_with_chaos",
           "maybe_crash_at_round", "SiloCrashed", "PartitionSpec",
           "parse_partitions"]
