"""fedguard — fault-tolerant delivery for the distributed message plane
(docs/FAULT_TOLERANCE.md).

The WAN tier was fire-and-forget: a send that a broker, a partition, or
a crashed peer swallowed simply never arrived, a dead rank surfaced as a
bare ``queue.Empty`` 400 frames deep, and a killed coordinator lost the
federation.  arXiv:2604.10859 shows the comm tier dominates cross-silo
wall-clock; an *unreliable* comm tier dominates it catastrophically.
This module adds the four transport-level pieces the drivers compose
into quorum rounds and crash-resume:

- :class:`ReliableCommManager` — an ack/retransmit decorator over any
  ``BaseCommunicationManager``.  Sender side: registered *reliable*
  msg types are tracked until an ACK for their ``fedscope.msg_id`` (the
  comm manager's stamp — one id per LOGICAL message, shared by every retry)
  arrives, retransmitting on an exponential-backoff-with-jitter
  schedule up to a per-message deadline.  Receiver side: every reliable
  delivery is ACKed (dupes re-ACK — the first ACK may itself have been
  lost) and deduped by msg_id BEFORE the FSM sees it, so retries are
  idempotent by construction.  ``comm.retry`` spans and
  ``comm.retries`` / ``comm.retry_rate`` / ``comm.ack_rtt`` counters
  land on the fedscope plane.
- **Heartbeat leases** — non-server ranks beacon
  :data:`MSG_TYPE_HEARTBEAT` at ``heartbeat_interval_s``; the server's
  manager tracks per-rank leases and :meth:`ReliableCommManager.
  dead_ranks` names every peer whose lease (``lease_s``) expired.  A
  rank that resumes beaconing (a healed partition) leaves the dead set
  again — death is a *lease state*, not a tombstone.
- :class:`RoundWAL` — an append-only applied-round journal next to the
  orbax checkpoint.  The coordinator records every applied round (with
  the msg_ids it consumed) AFTER the checkpoint lands; a restarted
  coordinator resumes at ``checkpoint round + 1`` and the WAL is the
  pinned no-double-apply witness (``tests``).
- :class:`ReliableEndpoint` — the queue-backed driver endpoint the
  hierarchy and async drivers share.  ``recv`` raises a
  :class:`TimeoutError` naming the waiting rank, the expected message,
  and the elapsed time instead of propagating a bare ``queue.Empty``.

ACK and HEARTBEAT are *transport* types: they live below every FSM, are
consumed here (never forwarded to handlers), and are registered in the
affected fedproto families' manifests under the ``transport`` block so
``check-trace`` knows them (``fedml_tpu/analysis/fedproto.py``).

Pure host plane: stdlib only — no jax anywhere near the retransmit path.

Port of ``fedml_tpu.core.distributed.reliability``: the same code; only
the wording of one sentence of this docstring differs (a CPU test pins
the rest byte for byte).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set

from ...obs import context as obs_context
from ...obs import get_tracer
from .communication.base_com_manager import BaseCommunicationManager, Observer
from .communication.message import Message

log = logging.getLogger(__name__)

#: transport-plane message types — disjoint from every FSM family's range
#: (cross_silo low ints, store-hierarchy 601..603, async 701..703).
#: fedproto's TRANSPORT_TYPES table mirrors these values; a unit test
#: pins the two in sync.
MSG_TYPE_ACK = 690
MSG_TYPE_HEARTBEAT = 691

#: params key carrying the msg_id an ACK acknowledges
KEY_ACK_OF = "fedguard.ack_of"
#: params key carrying the beaconing rank on a HEARTBEAT
KEY_HB_RANK = "fedguard.rank"
#: per-message reliability opt-out: a reliable-typed message sent with
#: this param set is fire-and-forget (no ack tracking, no retransmit) —
#: the drivers use it to keep PROBING lease-dead ranks with the round
#: dispatch (the rejoin path) without accruing retransmit obligations
#: toward peers that may never come back
KEY_UNRELIABLE = "fedguard.unreliable"


def _jitter01(msg_id: str, attempt: int) -> float:
    """Deterministic jitter in [0, 1): a pure function of (msg_id,
    attempt) so retry schedules are reproducible run-to-run — the chaos
    bench's 'seeded/deterministic' contract extends to backoff."""
    h = zlib.crc32(f"{msg_id}:{attempt}".encode())
    return (h & 0xFFFFFF) / float(0x1000000)


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter + a per-message
    deadline.  ``delay(attempt)`` is the wait BEFORE retry ``attempt``
    (attempt 1 = first retransmission)."""
    base_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.25
    deadline_s: float = 30.0

    def delay(self, msg_id: str, attempt: int) -> float:
        raw = min(self.base_s * (self.multiplier ** (attempt - 1)),
                  self.max_backoff_s)
        return raw * (1.0 + self.jitter * _jitter01(msg_id, attempt))

    @classmethod
    def from_args(cls, args) -> "RetryPolicy":
        d = cls()
        return cls(
            base_s=float(getattr(args, "retry_base_s", 0.0)
                         or d.base_s),
            multiplier=float(getattr(args, "retry_multiplier", 0.0)
                             or d.multiplier),
            max_backoff_s=float(getattr(args, "retry_max_backoff_s", 0.0)
                                or d.max_backoff_s),
            jitter=(d.jitter if getattr(args, "retry_jitter", None) is None
                    else float(args.retry_jitter)),
            deadline_s=float(getattr(args, "retry_deadline_s", 0.0)
                             or d.deadline_s))


@dataclass
class _Pending:
    msg: Message
    msg_id: str
    first_sent: float
    deadline_at: float
    next_at: float
    attempts: int = 0


@dataclass
class _Lease:
    last_seen: float
    beats: int = 0


class ReliableCommManager(BaseCommunicationManager, Observer):
    """Ack/retransmit + heartbeat-lease decorator.

    Wrap ORDER matters: reliability sits OUTSIDE fault injection
    (``Reliable(Chaos(Raw))``) so retransmissions traverse the injected
    drop/delay/partition faults — retransmit-beats-drop is exactly the
    property the chaos harness proves.
    """

    def __init__(self, inner: BaseCommunicationManager, rank: int,
                 size: int = 0,
                 reliable_types: Sequence[Any] = (),
                 policy: Optional[RetryPolicy] = None,
                 heartbeat_interval_s: float = 0.0,
                 lease_s: float = 0.0,
                 server_rank: int = 0,
                 dedupe_window: int = 4096):
        self.inner = inner
        self.rank = int(rank)
        self.size = int(size)
        self.server_rank = int(server_rank)
        self.policy = policy or RetryPolicy()
        self.reliable_types = {str(t) for t in reliable_types}
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.lease_s = float(lease_s)
        self._observers: List[Observer] = []
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._outstanding: Dict[str, _Pending] = {}
        self._seen: Set[str] = set()
        self._seen_order: List[str] = []
        self._dedupe_window = int(dedupe_window)
        self._leases: Dict[int, _Lease] = {}
        self._failed: List[str] = []
        self._started_at = time.monotonic()
        self._running = False
        self._closed = False
        # set by close(): wakes the beacon out of its inter-beat wait
        # immediately instead of lagging shutdown by up to one interval
        self._hb_wake = threading.Event()
        self._retx_thread: Optional[threading.Thread] = None
        self._hb_thread: Optional[threading.Thread] = None
        self.stats = {"sent": 0, "reliable_sent": 0, "retries": 0,
                      "acked": 0, "dup_dropped": 0, "exhausted": 0,
                      "acks_sent": 0, "heartbeats": 0}
        inner.add_observer(self)

    # -- sender side --------------------------------------------------------
    def send_message(self, msg: Message):
        params = msg.get_params()
        if obs_context.KEY_MSG_ID not in params:
            # reliability NEEDS the logical-message id even when tracing
            # is off (FedMLCommManager only stamps it for traced runs);
            # stamping here keeps one id per logical send, shared by
            # every retry and every chaos duplicate
            msg.add_params(obs_context.KEY_MSG_ID,
                           obs_context.new_span_id())
        mid = str(params[obs_context.KEY_MSG_ID])
        track = (str(msg.get_type()) in self.reliable_types
                 and msg.get_receiver_id() != self.rank
                 and not params.get(KEY_UNRELIABLE))
        with self._lock:
            self.stats["sent"] += 1
            if track:
                now = time.monotonic()
                self.stats["reliable_sent"] += 1
                self._outstanding[mid] = _Pending(
                    msg=msg, msg_id=mid, first_sent=now,
                    deadline_at=now + self.policy.deadline_s,
                    next_at=now + self.policy.delay(mid, 1))
                self._ensure_retx_thread()
                self._cv.notify_all()
        self.inner.send_message(msg)
        if track:
            self._emit_rates()

    def _ensure_retx_thread(self):
        if self._retx_thread is None and not self._closed:
            self._running = True
            self._retx_thread = threading.Thread(
                target=self._retransmit_loop,
                name=f"fedguard-retx-{self.rank}", daemon=True)
            self._retx_thread.start()

    def _retransmit_loop(self):
        while True:
            resend: List[_Pending] = []
            with self._cv:
                if not self._running:
                    return
                now = time.monotonic()
                due = [p for p in self._outstanding.values()
                       if p.next_at <= now]
                if not due:
                    nxt = min((p.next_at for p in
                               self._outstanding.values()),
                              default=now + 0.25)
                    self._cv.wait(timeout=max(0.005,
                                              min(nxt - now, 0.25)))
                    continue
                for p in due:
                    if now >= p.deadline_at:
                        del self._outstanding[p.msg_id]
                        self._failed.append(p.msg_id)
                        self.stats["exhausted"] += 1
                        log.error(
                            "fedguard: rank %d gave up on msg_type %s "
                            "to rank %s after %d retries (%.1fs "
                            "deadline, msg %s)", self.rank,
                            p.msg.get_type(), p.msg.get_receiver_id(),
                            p.attempts, self.policy.deadline_s, p.msg_id)
                        continue
                    p.attempts += 1
                    self.stats["retries"] += 1
                    p.next_at = now + self.policy.delay(p.msg_id,
                                                        p.attempts + 1)
                    resend.append(p)
            # re-send OUTSIDE the lock (backends may block)
            tracer = get_tracer()
            for p in resend:
                with tracer.span("comm.retry", cat="comm",
                                 msg_type=str(p.msg.get_type()),
                                 dst=p.msg.get_receiver_id(),
                                 attempt=p.attempts, msg_id=p.msg_id):
                    try:
                        self.inner.send_message(p.msg)
                    except Exception:   # noqa: BLE001 — a retry must
                        log.exception(   # never kill the loop; the next
                            "fedguard: retransmit failed")  # tick retries
            self._emit_rates()

    def _emit_rates(self):
        tracer = get_tracer()
        if not tracer.enabled:
            return
        with self._lock:
            sent = max(self.stats["reliable_sent"], 1)
            tracer.counter("comm.retries", float(self.stats["retries"]))
            tracer.counter("comm.retry_rate",
                           self.stats["retries"] / sent)
            if self.stats["exhausted"]:
                tracer.counter("comm.retry_exhausted",
                               float(self.stats["exhausted"]))

    # -- receiver side ------------------------------------------------------
    def receive_message(self, msg_type, msg_params) -> None:
        """Observer hook from the inner backend — transport types are
        consumed here; everything else is ACKed (if reliable), deduped,
        and forwarded to the outer observers (the FSM)."""
        t = str(msg_type)
        if t == str(MSG_TYPE_ACK):
            self._on_ack(msg_params)
            return
        if t == str(MSG_TYPE_HEARTBEAT):
            self._on_heartbeat(msg_params)
            return
        mid = msg_params.get(obs_context.KEY_MSG_ID) \
            if hasattr(msg_params, "get") else None
        if t in self.reliable_types and mid is not None:
            self._send_ack(msg_params, str(mid))
        if mid is not None:
            with self._lock:
                if str(mid) in self._seen:
                    self.stats["dup_dropped"] += 1
                    tracer = get_tracer()
                    if tracer.enabled:
                        tracer.counter("comm.dup_dropped",
                                       float(self.stats["dup_dropped"]))
                    return
                self._seen.add(str(mid))
                self._seen_order.append(str(mid))
                if len(self._seen_order) > self._dedupe_window:
                    self._seen.discard(self._seen_order.pop(0))
        for obs in list(self._observers):
            obs.receive_message(msg_type, msg_params)

    def _recv_span(self, name_type: str, msg_params, **extra):
        """The transport plane's own ``comm.recv`` span — ACK/HEARTBEAT
        never reach ``FedMLCommManager.receive_message``, so without
        this their backend ``comm.send`` spans would read as message
        loss to ``fedproto check-trace``."""
        tracer = get_tracer()
        if not tracer.enabled:
            return _NULL_CTX
        ctx = obs_context.extract(msg_params)
        kw: Dict[str, Any] = {"msg_type": name_type,
                              "msg_id": msg_params.get(
                                  obs_context.KEY_MSG_ID)}
        kw.update(extra)
        if ctx is not None:
            kw.update(parent_span=ctx["span_id"],
                      remote_trace=ctx["trace_id"])
        return tracer.span("comm.recv", cat="comm", **kw)

    def _on_ack(self, msg_params):
        mid = msg_params.get(KEY_ACK_OF)
        with self._recv_span(str(MSG_TYPE_ACK), msg_params,
                             ack_of=mid):
            rtt = None
            with self._lock:
                p = self._outstanding.pop(str(mid), None)
                if p is not None:
                    self.stats["acked"] += 1
                    rtt = time.monotonic() - p.first_sent
                self._cv.notify_all()
            if rtt is not None:
                tracer = get_tracer()
                if tracer.enabled:
                    tracer.counter("comm.ack_rtt", rtt)

    def _on_heartbeat(self, msg_params):
        try:
            rank = int(msg_params.get(KEY_HB_RANK))
        except (TypeError, ValueError):
            return
        with self._recv_span(str(MSG_TYPE_HEARTBEAT), msg_params,
                             src=rank):
            with self._lock:
                lease = self._leases.setdefault(rank,
                                                _Lease(time.monotonic()))
                lease.last_seen = time.monotonic()
                lease.beats += 1

    def _send_ack(self, msg_params, mid: str):
        try:
            sender = int(msg_params.get_sender_id()) \
                if hasattr(msg_params, "get_sender_id") \
                else int(msg_params.get("sender"))
        except (KeyError, TypeError, ValueError):
            return
        if sender == self.rank:
            return
        ack = Message(MSG_TYPE_ACK, self.rank, sender)
        ack.add_params(KEY_ACK_OF, mid)
        ack.add_params(obs_context.KEY_MSG_ID, obs_context.new_span_id())
        with self._lock:
            self.stats["acks_sent"] += 1
        self.inner.send_message(ack)

    # -- heartbeat / lease plane --------------------------------------------
    def start_heartbeats(self, expected_ranks: Sequence[int] = ()):
        """Server side: seed leases for every expected peer (a rank
        that NEVER beacons must still expire); non-server side: start
        the beacon thread toward ``server_rank``."""
        now = time.monotonic()
        with self._lock:
            for r in expected_ranks:
                self._leases.setdefault(int(r), _Lease(now))
        if (self.heartbeat_interval_s > 0
                and self.rank != self.server_rank
                and self._hb_thread is None
                and not self._closed):
            self._running = True
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                name=f"fedguard-hb-{self.rank}", daemon=True)
            self._hb_thread.start()

    def _heartbeat_loop(self):
        while True:
            with self._lock:
                if not self._running:
                    return
            hb = Message(MSG_TYPE_HEARTBEAT, self.rank, self.server_rank)
            hb.add_params(KEY_HB_RANK, self.rank)
            hb.add_params(obs_context.KEY_MSG_ID,
                          obs_context.new_span_id())
            try:
                self.inner.send_message(hb)
                with self._lock:
                    self.stats["heartbeats"] += 1
            except Exception:  # noqa: BLE001 — beacon must outlive faults
                log.exception("fedguard: heartbeat send failed")
            # interruptible inter-beat wait: close() sets _hb_wake so
            # shutdown never blocks on a full heartbeat interval
            if self._hb_wake.wait(self.heartbeat_interval_s):
                return

    def dead_ranks(self) -> Set[int]:
        """Ranks whose heartbeat lease expired.  Dynamic: a healed rank
        whose beacons resume leaves the set again (partition-and-heal)."""
        if self.lease_s <= 0:
            return set()
        now = time.monotonic()
        with self._lock:
            return {r for r, l in self._leases.items()
                    if now - l.last_seen > self.lease_s}

    def failed_msg_ids(self) -> List[str]:
        with self._lock:
            return list(self._failed)

    def outstanding(self) -> int:
        with self._lock:
            return len(self._outstanding)

    # -- delegation ---------------------------------------------------------
    def add_observer(self, observer: Observer):
        self._observers.append(observer)

    def remove_observer(self, observer: Observer):
        if observer in self._observers:
            self._observers.remove(observer)

    def handle_receive_message(self):
        self.inner.handle_receive_message()

    def stop_receive_message(self, flush_s: float = 0.0):
        """Stop the retransmit/heartbeat threads, optionally granting
        in-flight reliable sends ``flush_s`` to get acked first (the
        server's FINISH fan-out)."""
        self.close(flush_s=flush_s)

    def close(self, flush_s: float = 0.0):
        """Idempotent shutdown: optionally flush, then cancel every
        outstanding retransmit obligation, stop the retransmit loop and
        heartbeat beacon with bounded joins, and stop the inner backend
        exactly once.  Safe to call from atexit, a crash handler, AND the
        normal exit path in any order — later calls are no-ops."""
        if flush_s > 0 and not self._closed:
            deadline = time.monotonic() + flush_s
            while time.monotonic() < deadline and self.outstanding():
                time.sleep(0.02)
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._running = False
            # unacked sends are cancelled, not failed: shutdown is not a
            # delivery verdict, so they don't join _failed
            self._outstanding.clear()
            self._hb_wake.set()
            self._cv.notify_all()
        for th in (self._retx_thread, self._hb_thread):
            if th is not None:
                th.join(timeout=2.0)
        self._retx_thread = None
        self._hb_thread = None
        self.inner.stop_receive_message()


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL_CTX = _NullCtx()


def maybe_wrap_reliable(manager: BaseCommunicationManager, args,
                        rank: int, size: int) -> BaseCommunicationManager:
    """args-gated decoration (called from ``create_comm_backend`` AFTER
    chaos wrapping, so retries traverse the injected faults).  Gate:
    ``reliable_delivery=True``; the driver sets ``reliable_types`` to
    its protocol's payload types before building endpoints."""
    if not bool(getattr(args, "reliable_delivery", False)):
        return manager
    return ReliableCommManager(
        manager, rank=rank, size=size,
        reliable_types=list(getattr(args, "reliable_types", ()) or ()),
        policy=RetryPolicy.from_args(args),
        heartbeat_interval_s=float(
            getattr(args, "heartbeat_interval_s", 0.0) or 0.0),
        lease_s=float(getattr(args, "lease_s", 0.0) or 0.0),
        server_rank=int(getattr(args, "server_rank", 0) or 0))


def find_reliable(manager) -> Optional[ReliableCommManager]:
    """Walk a decorator chain (reliable → chaos → raw) to the
    reliability layer, if one is installed."""
    m = manager
    while m is not None:
        if isinstance(m, ReliableCommManager):
            return m
        m = getattr(m, "inner", None)
    return None


# --------------------------------------------------------------------------
# driver endpoint — shared by store/hierarchy.py and async_driver.py
# --------------------------------------------------------------------------

class ReliableEndpoint:
    """Queue-backed endpoint over the real FedMLCommManager receive path
    (handlers run on the comm loop thread and enqueue; the driver's
    round loop consumes from the queue).  Subclasses construct the
    manager (whose inline ``_Mgr`` keeps fedproto's static handler
    extraction anchored in the driver module) and hand it here."""

    def __init__(self, mgr, inbox: "queue.Queue", rank: int):
        self._mgr = mgr
        self.inbox = inbox
        self.rank = int(rank)
        self._thread = threading.Thread(target=self._mgr.run, daemon=True)
        self._thread.start()

    @property
    def guard(self) -> Optional[ReliableCommManager]:
        return find_reliable(self._mgr.com_manager)

    def send(self, msg: Message):
        self._mgr.send_message(msg)

    def recv(self, timeout_s: float = 120.0,
             expect: Optional[str] = None) -> Message:
        """Blocking receive.  On timeout raises :class:`TimeoutError`
        naming the waiting rank, the expected message, and the elapsed
        time — never a bare ``queue.Empty`` from 400 lines deep."""
        t0 = time.monotonic()
        try:
            return self.inbox.get(timeout=timeout_s)
        except queue.Empty:
            raise TimeoutError(
                f"rank {self.rank}: no {expect or 'message'} arrived "
                f"within {time.monotonic() - t0:.1f}s "
                f"(timeout_s={timeout_s:g}) — peer dead, partitioned, "
                "or the protocol deadlocked") from None

    def poll(self, timeout_s: float) -> Optional[Message]:
        """Non-raising receive tick for deadline-driven wait loops."""
        try:
            return self.inbox.get(timeout=timeout_s)
        except queue.Empty:
            return None

    def close(self, flush_s: float = 0.0):
        g = self.guard
        if g is not None:
            g.stop_receive_message(flush_s=flush_s)
            # FedMLCommManager.finish() would stop the chain again —
            # already done through the guard; just stop the loop thread
        else:
            self._mgr.finish()
        self._thread.join(timeout=5.0)


# --------------------------------------------------------------------------
# applied-round write-ahead journal (crash-resume, rank 0)
# --------------------------------------------------------------------------

class RoundWAL:
    """Append-only JSONL journal of APPLIED rounds, next to the orbax
    checkpoint.  Write protocol (rank 0, per round): combine → orbax
    save → ``wal.record(round, msg_ids)``.  Restart protocol: restore
    the latest checkpoint round ``c``, ``wal.ensure(c)`` (backfills a
    ``recovered`` entry iff the crash landed between checkpoint and
    journal append), resume dispatch at ``c + 1``.  Invariant — the
    pinned no-double-apply witness: every round index appears EXACTLY
    once across all coordinator lives.  A torn final line (the crash
    mid-append) is ignored on read."""

    def __init__(self, directory: str, name: str = "round_wal.jsonl"):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, name)

    def record(self, round_idx: int, msg_ids: Sequence[str] = (),
               quorum: Optional[int] = None, recovered: bool = False,
               state_digest: Optional[str] = None):
        entry: Dict[str, Any] = {"round": int(round_idx),
                                 "msg_ids": list(msg_ids)}
        if quorum is not None:
            entry["quorum"] = int(quorum)
        if recovered:
            entry["recovered"] = True
        if state_digest is not None:
            # fedwire unification (docs/WIRE.md): crc32 of the round's
            # ENCODED state payload — the same bytes the wire shipped and
            # the wire checkpoint wrote — ties journal, wire and
            # checkpoint to one codec
            entry["state_digest"] = str(state_digest)
        # terminate any torn tail first (crash mid-append), so the new
        # record never concatenates onto half a line
        lead = ""
        if os.path.exists(self.path) and os.path.getsize(self.path):
            with open(self.path, "rb") as fh:
                fh.seek(-1, os.SEEK_END)
                if fh.read(1) != b"\n":
                    lead = "\n"
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(lead + json.dumps(entry) + "\n")
            fh.flush()
            os.fsync(fh.fileno())

    def entries(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return []
        out: List[Dict[str, Any]] = []
        with open(self.path, "r", encoding="utf-8") as fh:
            lines = fh.read().split("\n")
        for line in lines:
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                # a torn line is a crash mid-append (json.dumps never
                # emits newlines, so tearing cannot merge two records);
                # after a restart the journal appends PAST it, so skip
                # wherever it sits — the round it described was never
                # durably applied
                log.warning("fedguard WAL: skipping torn line in %s",
                            self.path)
        return out

    def rounds(self) -> List[int]:
        return [int(e["round"]) for e in self.entries()]

    def last_applied(self) -> Optional[int]:
        rs = self.rounds()
        return max(rs) if rs else None

    def applied_msg_ids(self) -> Set[str]:
        out: Set[str] = set()
        for e in self.entries():
            out.update(str(m) for m in e.get("msg_ids", ()))
        return out

    def ensure(self, round_idx: Optional[int]):
        """Backfill the checkpoint round if its journal entry is missing
        (crash in the checkpoint→append window)."""
        if round_idx is None:
            return
        if int(round_idx) not in self.rounds():
            self.record(int(round_idx), recovered=True)


__all__ = [
    "MSG_TYPE_ACK", "MSG_TYPE_HEARTBEAT", "KEY_ACK_OF", "KEY_HB_RANK",
    "KEY_UNRELIABLE", "RetryPolicy", "ReliableCommManager",
    "ReliableEndpoint", "RoundWAL", "maybe_wrap_reliable",
    "find_reliable",
]
