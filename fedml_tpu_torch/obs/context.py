"""fedscope trace-context propagation — W3C-style ids across processes.

One federation run spans many OS processes (server, silo workers, edge
clients) exchanging :class:`~fedml_tpu.core.distributed.communication.
message.Message` objects.  Without shared ids, each process's fedtrace
capture is an island: a ``comm.send`` span on the sender has no
relationship to the handler span on the receiver, so ``tools/fedtrace.py
merge`` could align clocks but never *link* work.  This module closes
that gap with the W3C Trace Context wire format
(https://www.w3.org/TR/trace-context/: ``traceparent =
"00-<32 hex trace id>-<16 hex span id>-<2 hex flags>"``) carried inside
message params under ``fedscope.*`` keys:

- :func:`inject` stamps an outbound carrier dict with the current
  traceparent (trace id + the *sending span's* id), plus the sender's
  host/pid so the receiver can tag its handler span with the true remote
  identity even before a merge.
- :func:`extract` reads those keys back on the receiver; the comm
  manager opens its ``comm.recv`` span with ``parent_span=<sender span
  id>`` — the cross-process edge ``fedtrace critical-path`` walks.

Pure stdlib; safe to import from comm managers that never touch jax.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional

#: message-params keys the context rides in (flat strings so every
#: backend — msgpack, JSON-over-MQTT, filestore blobs — carries them
#: unchanged)
KEY_TRACEPARENT = "fedscope.traceparent"
KEY_HOST = "fedscope.host"
KEY_PID = "fedscope.pid"
#: one id per LOGICAL message, stamped by FedMLCommManager.send_message
#: ABOVE the backend (and above fault injection), so every duplicated
#: delivery of one send carries the same id — ``fedproto check-trace``
#: matches sends to recvs through it and flags re-deliveries
KEY_MSG_ID = "fedscope.msg_id"

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def new_trace_id() -> str:
    """128-bit random trace id, 32 lowercase hex chars."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """64-bit random span id, 16 lowercase hex chars."""
    return os.urandom(8).hex()


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value: str) -> Optional[Dict[str, str]]:
    """``traceparent`` string → ``{"trace_id", "span_id"}`` or None."""
    if not isinstance(value, str):
        return None
    m = _TRACEPARENT_RE.match(value)
    if not m:
        return None
    return {"trace_id": m.group(1), "span_id": m.group(2)}


def inject(carrier: Dict[str, Any], tracer=None) -> Dict[str, Any]:
    """Stamp ``carrier`` (message params dict) with the current trace
    context.  No-op when tracing is disabled — untraced runs put zero
    extra bytes on the wire."""
    if tracer is None:
        from .tracer import get_tracer
        tracer = get_tracer()
    if not tracer.enabled:
        return carrier
    span_id = tracer.current_span_id() or "0" * 16
    carrier[KEY_TRACEPARENT] = format_traceparent(tracer.trace_id, span_id)
    carrier[KEY_HOST] = tracer.host
    carrier[KEY_PID] = tracer.pid
    return carrier


def extract(carrier: Any) -> Optional[Dict[str, Any]]:
    """Read an injected context back out of message params.

    ``carrier`` may be a plain mapping or anything with ``.get`` (the
    ``Message`` object).  Returns ``{"trace_id", "span_id", "host",
    "pid"}`` or None when no (valid) context rides the message."""
    get = carrier.get if hasattr(carrier, "get") else None
    if get is None:
        return None
    parsed = parse_traceparent(get(KEY_TRACEPARENT))
    if parsed is None:
        return None
    out: Dict[str, Any] = dict(parsed)
    out["host"] = get(KEY_HOST)
    pid = get(KEY_PID)
    out["pid"] = int(pid) if pid is not None else None
    return out


# -- topology tier classification ------------------------------------------

#: rank 0 is the server in every FedML topology (cross_silo FSMs, the
#: hierarchy driver); traffic touching it crosses the silo→server DCN
#: tier, everything else stays inside a silo
TIER_SILO_SERVER = "silo_server"
TIER_INTRA_SILO = "intra_silo"


def comm_tier(sender: Any, receiver: Any, server_rank: int = 0) -> str:
    """Classify one message edge for the per-tier byte/latency counters
    (``comm.bytes.<tier>`` / ``comm.rtt.<tier>``) — the measured twin of
    fedverify's modeled byte census, split the way arXiv:2604.10859
    splits cross-silo cost: silo→server DCN vs intra-silo traffic."""
    try:
        s, r = int(sender), int(receiver)
    except (TypeError, ValueError):
        return TIER_INTRA_SILO
    return TIER_SILO_SERVER if server_rank in (s, r) else TIER_INTRA_SILO
