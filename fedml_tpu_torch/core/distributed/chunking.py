"""fedwire chunked framing — stream large messages as bounded frames
(docs/WIRE.md).

A monolithic multi-megabyte partial is the worst case for fedguard's
fault model: under a modeled bandwidth cap (``chaos_bandwidth_bps``) one
message can hold the link longer than the retransmit deadline, so the
reliability layer re-enqueues the WHOLE payload and the link congests
into a stall.  Chunked framing bounds every frame at
``args.wire_chunk_bytes``: each chunk is its own transport message with
its OWN ``fedscope.msg_id``, so fedguard acks/retransmits/dedupes
per-chunk — a drop costs one frame's retransmission, not the payload —
and rounds degrade gracefully instead of stalling.

Wire format: the logical message's params serialize once
(``encode_tree``); the bytes split into ``total`` frames of type
:data:`MSG_TYPE_CHUNK` (transport plane, next to ACK/HEARTBEAT — fedproto
registers it in the affected families' ``transport`` manifests).  Frame
params: ``fedwire.parent`` (the LOGICAL ``fedscope.msg_id``),
``fedwire.seq`` / ``fedwire.total``, ``fedwire.msg_type`` (the original
type, for observability), and the ``fedwire.data`` byte slice.  Chunk ids
are derived (``<parent>/c<seq>``), so retransmissions of one frame share
one id and dedupe below us, exactly like any reliable message.

The receiver half reassembles by ``(sender, parent)`` and forwards the
RECONSTRUCTED logical message — original type, original msg_id, original
params — to the FSM observers, so drivers, WAL msg_id journaling, and
fedproto's one-logical-message accounting are unchanged: one logical
partial = N chunk frames under one ``fedscope.msg_id``
(``analysis/fedproto.py`` check-trace groups them by ``fedwire.parent``).

Wrap order: ``Chunking(Reliable(Chaos(Raw)))`` — frames ride reliable
delivery per-chunk (:data:`MSG_TYPE_CHUNK` joins ``reliable_types``), and
retransmissions traverse the injected faults.  ``comm.chunk`` spans carry
seq/total/parent so ``fedtrace critical-path`` shows the streaming
overlap on the merged timeline.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Tuple

from ...obs import context as obs_context
from ...obs import get_tracer
from .communication.base_com_manager import (BaseCommunicationManager,
                                             Observer)
from .communication.message import Message, decode_tree, encode_tree
from .reliability import KEY_UNRELIABLE, find_reliable

log = logging.getLogger(__name__)

#: transport-plane frame type, next to ACK (690) / HEARTBEAT (691);
#: fedproto's TRANSPORT_TYPES table mirrors it (a unit test pins the sync)
MSG_TYPE_CHUNK = 692

#: frame params (below the FSM contract, like the ``fedguard.*`` keys)
KEY_CHUNK_PARENT = "fedwire.parent"
KEY_CHUNK_SEQ = "fedwire.seq"
KEY_CHUNK_TOTAL = "fedwire.total"
KEY_CHUNK_TYPE = "fedwire.msg_type"
KEY_CHUNK_DATA = "fedwire.data"

#: reassembly buffers kept per (sender, parent) before the oldest
#: incomplete one is dropped (a crashed sender's torn stream must not
#: leak memory forever)
_MAX_PARTIAL_STREAMS = 64


class ChunkingCommManager(BaseCommunicationManager, Observer):
    """Bounded-frame streaming decorator over any comm backend."""

    def __init__(self, inner: BaseCommunicationManager, rank: int,
                 max_chunk_bytes: int):
        self.inner = inner
        self.rank = int(rank)
        self.max_chunk_bytes = int(max_chunk_bytes)
        self._observers: List[Observer] = []
        self._lock = threading.Lock()
        # (sender, parent) -> {seq: bytes}; OrderedDict = drop-oldest cap
        self._partial: "OrderedDict[Tuple[Any, str], Dict[int, bytes]]" \
            = OrderedDict()
        self._expected: Dict[Tuple[Any, str], int] = {}
        self.stats = {"chunked_sends": 0, "chunks_sent": 0,
                      "chunks_recv": 0, "reassembled": 0,
                      "streams_dropped": 0}
        inner.add_observer(self)
        guard = find_reliable(inner)
        if guard is not None:
            # frames ride reliable delivery per-chunk: one dropped frame
            # costs one frame's retransmission, not the whole payload
            guard.reliable_types.add(str(MSG_TYPE_CHUNK))

    # -- sender side --------------------------------------------------------
    def send_message(self, msg: Message):
        t = msg.get_type()
        if self.max_chunk_bytes <= 0 or t == MSG_TYPE_CHUNK:
            self.inner.send_message(msg)
            return
        params = msg.get_params()
        if obs_context.KEY_MSG_ID not in params:
            # the logical id IS the frame-group key — stamp it here if
            # neither the FSM (tracing) nor reliability stamped it yet
            msg.add_params(obs_context.KEY_MSG_ID,
                           obs_context.new_span_id())
        blob = encode_tree(params)
        if len(blob) <= self.max_chunk_bytes:
            self.inner.send_message(msg)
            return
        parent = str(params[obs_context.KEY_MSG_ID])
        total = -(-len(blob) // self.max_chunk_bytes)
        tracer = get_tracer()
        with self._lock:
            self.stats["chunked_sends"] += 1
            self.stats["chunks_sent"] += total
        for seq in range(total):
            frame = Message(MSG_TYPE_CHUNK, msg.get_sender_id(),
                            msg.get_receiver_id())
            frame.add_params(KEY_CHUNK_PARENT, parent)
            frame.add_params(KEY_CHUNK_SEQ, seq)
            frame.add_params(KEY_CHUNK_TOTAL, total)
            frame.add_params(KEY_CHUNK_TYPE, str(t))
            frame.add_params(KEY_CHUNK_DATA,
                             blob[seq * self.max_chunk_bytes:
                                  (seq + 1) * self.max_chunk_bytes])
            # derived id: retransmits of one frame share it (dedupe key);
            # distinct frames never collide
            frame.add_params(obs_context.KEY_MSG_ID, f"{parent}/c{seq}")
            if "round_idx" in params:
                frame.add_params("round_idx", params["round_idx"])
            if params.get(KEY_UNRELIABLE):
                # a fire-and-forget probe stays fire-and-forget per frame
                frame.add_params(KEY_UNRELIABLE, True)
            if tracer.enabled:
                # fedscope streaming-overlap evidence: one comm.chunk
                # span per frame, grouped by the parent logical id
                with tracer.span("comm.chunk", cat="comm", seq=seq,
                                 total=total, parent=parent,
                                 msg_type=str(t),
                                 dst=msg.get_receiver_id(),
                                 nbytes=len(frame.get(KEY_CHUNK_DATA))):
                    self.inner.send_message(frame)
            else:
                self.inner.send_message(frame)
        if tracer.enabled:
            tracer.counter("comm.chunks_sent",
                           float(self.stats["chunks_sent"]))

    # -- receiver side ------------------------------------------------------
    def receive_message(self, msg_type, msg_params) -> None:
        if str(msg_type) != str(MSG_TYPE_CHUNK):
            for obs in list(self._observers):
                obs.receive_message(msg_type, msg_params)
            return
        parent = str(msg_params.get(KEY_CHUNK_PARENT))
        seq = int(msg_params.get(KEY_CHUNK_SEQ))
        total = int(msg_params.get(KEY_CHUNK_TOTAL))
        sender = msg_params.get_sender_id()
        key = (sender, parent)
        tracer = get_tracer()
        if tracer.enabled:
            # the transport plane's own recv evidence (chunk frames never
            # reach FedMLCommManager.receive_message, like ACK/HEARTBEAT)
            ctx = obs_context.extract(msg_params)
            kw: Dict[str, Any] = {"msg_type": str(MSG_TYPE_CHUNK),
                                  "msg_id": msg_params.get(
                                      obs_context.KEY_MSG_ID),
                                  "seq": seq, "total": total,
                                  "parent": parent}
            if ctx is not None:
                kw.update(parent_span=ctx["span_id"],
                          remote_trace=ctx["trace_id"])
            with tracer.span("comm.recv", cat="comm", **kw):
                pass
        data = msg_params.get(KEY_CHUNK_DATA)
        done = None
        with self._lock:
            self.stats["chunks_recv"] += 1
            buf = self._partial.get(key)
            if buf is None:
                buf = self._partial[key] = {}
                self._expected[key] = total
                while len(self._partial) > _MAX_PARTIAL_STREAMS:
                    dropped, _ = self._partial.popitem(last=False)
                    self._expected.pop(dropped, None)
                    self.stats["streams_dropped"] += 1
                    log.warning("fedwire: dropping torn chunk stream %s",
                                dropped)
            buf[seq] = bytes(data)
            if len(buf) == self._expected.get(key, total):
                done = b"".join(buf[i] for i in range(total))
                del self._partial[key]
                self._expected.pop(key, None)
                self.stats["reassembled"] += 1
        if done is None:
            return
        logical = Message()
        logical.init(decode_tree(done))
        for obs in list(self._observers):
            obs.receive_message(logical.get_type(), logical)

    # -- delegation ---------------------------------------------------------
    def add_observer(self, observer: Observer):
        self._observers.append(observer)

    def remove_observer(self, observer: Observer):
        if observer in self._observers:
            self._observers.remove(observer)

    def handle_receive_message(self):
        self.inner.handle_receive_message()

    def stop_receive_message(self, *a, **kw):
        # drain-then-close: the inner stop (reliable flush window rides
        # through *a/**kw) finishes first, THEN torn reassembly buffers
        # drop — a stream that completes during the flush still delivers
        self.inner.stop_receive_message(*a, **kw)
        with self._lock:
            if self._partial:
                log.warning("fedwire: dropping %d torn chunk stream(s) "
                            "at close", len(self._partial))
                self.stats["streams_dropped"] += len(self._partial)
            self._partial.clear()
            self._expected.clear()


def maybe_wrap_chunking(manager: BaseCommunicationManager, args,
                        rank: int) -> BaseCommunicationManager:
    """args-gated decoration, OUTERMOST in the stack
    (``Chunking(Reliable(Chaos(Raw)))``) so every frame is its own
    reliable message.  Gate: ``wire_chunk_bytes > 0``."""
    chunk = int(getattr(args, "wire_chunk_bytes", 0) or 0)
    if chunk <= 0:
        return manager
    return ChunkingCommManager(manager, rank=rank, max_chunk_bytes=chunk)


def find_chunking(manager):
    m = manager
    while m is not None:
        if isinstance(m, ChunkingCommManager):
            return m
        m = getattr(m, "inner", None)
    return None


__all__ = [
    "MSG_TYPE_CHUNK", "KEY_CHUNK_PARENT", "KEY_CHUNK_SEQ",
    "KEY_CHUNK_TOTAL", "KEY_CHUNK_TYPE", "KEY_CHUNK_DATA",
    "ChunkingCommManager", "maybe_wrap_chunking", "find_chunking",
]
