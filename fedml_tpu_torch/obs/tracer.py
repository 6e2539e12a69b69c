"""obs.Tracer — host-side spans and counters behind the fedtrace plane
(port of ``fedml_tpu.obs.tracer``).

Design constraints (the whole point of this module):

- **Disabled means free.** Every public method early-returns on one
  attribute check; ``span()`` returns a shared no-op context manager, so
  call sites on the round hot path cost a branch when tracing is off.
- **Enabled means sync-free.** The tracer only ever reads host clocks and
  host ints; it never touches a device value.  Device-side telemetry
  arrives through :mod:`.carry` at the driver's existing log-round sync
  (:meth:`Tracer.round_obs`), never through a tracer-initiated transfer.
- **Chrome trace-event output.** ``export_chrome`` writes the JSON object
  format (``{"traceEvents": [...]}``) with paired ``B``/``E`` duration
  events per thread, ``C`` counter events, and ``M`` metadata — loadable
  in Perfetto (ui.perfetto.dev) or ``chrome://tracing``.  Events sort by
  timestamp at export; still-open spans get a synthesized end so the file
  is always well-formed.
- **Prometheus-style aggregates.** ``export_prometheus`` renders the
  running span totals and counters as a text-format dump for scrape-style
  consumption without parsing the full trace.

What differs from the JAX module: ``configure(hooks=True)`` subscribes the
tracer to the port's own hub (:mod:`.torchhooks`: CUDA-graph captures as
``cuda_graph_capture`` events on the retroactive lane, the explicit
host↔device copies as ``device_put_bytes``/``device_get_bytes``) where the
JAX module hooks jax's compile events and ``device_put``/``device_get``;
``jax_hooks=True`` raises by name.  :func:`tree_nbytes`
(``jaxhooks.tree_nbytes`` in the JAX package) lives here, walking nested
dicts and lists of numpy arrays, tensors and bytes.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from . import context as trace_context

#: device phases attributed from the ObsCarry FLOP weights, in the order
#: they appear in ``ObsCarry.phase_flops``
DEVICE_PHASES = ("gather", "client_steps", "merge", "server_update")
#: full per-round phase set (staging is host-measured via real spans)
PHASES = ("staging",) + DEVICE_PHASES

#: synthetic thread lane for retroactive spans (a CUDA-graph capture's
#: duration arrives after the fact; emitting it on the caller thread would
#: cross-nest with whatever span is open there)
COMPILE_TID = -2

_PROM_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_PROM_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    """A legal Prometheus metric name: every reserved character folds to
    ``_`` and a leading digit gains one (``serve.tokens/s`` →
    ``serve_tokens_s``).  The historical dump interpolated raw names —
    a counter or span named outside ``[a-zA-Z0-9_:]`` emitted a line a
    Prometheus parser rejects."""
    name = _PROM_NAME_BAD.sub("_", str(name))
    if not name or not _PROM_NAME_OK.match(name):
        name = "_" + name
    return name


def escape_label_value(value) -> str:
    """Prometheus label-value escaping: backslash, double-quote and
    newline (the three characters the text format reserves — adapter
    names / span args containing ``"`` previously broke the dump)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class _NullSpan:
    """Shared no-op context manager returned when tracing is disabled."""

    __slots__ = ()
    span_id = None       # mirror _SpanCtx so call sites read them freely
    duration_s = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "span_id",
                 "duration_s")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self.span_id: Optional[str] = None
        self.duration_s: Optional[float] = None

    def __enter__(self):
        self.span_id = self._tracer.begin(self._name, cat=self._cat,
                                          **self._args)
        return self

    def __exit__(self, *exc):
        self.duration_s = self._tracer.end(self._name)
        return False


class Tracer:
    """Thread-safe trace-event recorder (see module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        # tid -> stack of (name, ts_us, span_id) for B/E pairing and the
        # thread's current-span parentage (fedscope ids)
        self._open: Dict[int, List[tuple]] = {}
        # name -> [count, total_seconds] for the prometheus aggregate
        self._span_agg: Dict[str, List[float]] = {}
        self._counters: Dict[str, float] = {}
        self.enabled = False
        self.path: Optional[str] = None
        self.dropped_ends = 0
        self._origin = time.perf_counter()
        # wall-clock anchor captured at the SAME instant as the perf
        # origin: ``fedtrace merge`` maps every process's relative ts onto
        # unix time through it before the handshake refinement
        self._origin_unix_us = time.time() * 1e6
        self._pid = os.getpid()
        self.host = socket.gethostname()
        #: human label for the merged timeline ("server" / "silo2" ...)
        self.label: Optional[str] = None
        #: W3C 128-bit trace id — one per process session; adopted ids
        #: would arrive through configure(trace_id=...)
        self.trace_id = trace_context.new_trace_id()
        self._dirty = False

    # -- identity ----------------------------------------------------------
    @property
    def pid(self) -> int:
        return self._pid

    def current_span_id(self) -> Optional[str]:
        """Span id of the innermost open span on the calling thread (the
        parent every injected outbound context names)."""
        with self._lock:
            stack = self._open.get(threading.get_ident())
            return stack[-1][2] if stack else None

    def current_traceparent(self) -> str:
        return trace_context.format_traceparent(
            self.trace_id, self.current_span_id() or "0" * 16)

    # -- clock -------------------------------------------------------------
    def _ts(self) -> float:
        """Microseconds since tracer origin (Chrome trace ts unit)."""
        return (time.perf_counter() - self._origin) * 1e6

    def reset(self):
        with self._lock:
            self._events.clear()
            self._open.clear()
            self._span_agg.clear()
            self._counters.clear()
            self.dropped_ends = 0
            self._origin = time.perf_counter()
            self._origin_unix_us = time.time() * 1e6
            self.trace_id = trace_context.new_trace_id()
            self._dirty = False

    # -- spans -------------------------------------------------------------
    def begin(self, name: str, cat: str = "host", **args) -> Optional[str]:
        """Open a span; returns its fedscope span id.  The B event is
        tagged with pid/host plus ``span_id`` / ``parent`` args so a
        merged multi-process timeline keeps full parentage."""
        if not self.enabled:
            return None
        ts = self._ts()
        tid = threading.get_ident()
        span_id = trace_context.new_span_id()
        ev: Dict[str, Any] = {"name": name, "ph": "B", "ts": ts,
                              "pid": self._pid, "tid": tid, "cat": cat,
                              "host": self.host}
        clean = {k: v for k, v in args.items() if v is not None}
        clean["span_id"] = span_id
        with self._lock:
            stack = self._open.setdefault(tid, [])
            if stack:
                clean.setdefault("parent", stack[-1][2])
            ev["args"] = clean
            self._events.append(ev)
            self._dirty = True
            stack.append((name, ts, span_id))
        return span_id

    def end(self, name: str, **args) -> Optional[float]:
        """Close the most recent open span named ``name`` on this thread;
        returns its duration in seconds, or None if no matching begin
        exists (the unmatched end is dropped, keeping exports paired)."""
        if not self.enabled:
            return None
        ts = self._ts()
        tid = threading.get_ident()
        with self._lock:
            stack = self._open.get(tid, [])
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] == name:
                    _, t0, _sid = stack.pop(i)
                    break
            else:
                self.dropped_ends += 1
                return None
            ev: Dict[str, Any] = {"name": name, "ph": "E", "ts": ts,
                                  "pid": self._pid, "tid": tid,
                                  "host": self.host}
            if args:
                ev["args"] = dict(args)
            self._events.append(ev)
            self._dirty = True
            dur = (ts - t0) / 1e6
            agg = self._span_agg.setdefault(name, [0, 0.0])
            agg[0] += 1
            agg[1] += dur
            return dur

    def span(self, name: str, cat: str = "host", **args):
        """Context-manager span; a shared no-op object when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _SpanCtx(self, name, cat, args)

    def complete(self, name: str, duration_s: float, cat: str = "host",
                 tid: int = COMPILE_TID, end_s_ago: float = 0.0, **args):
        """Retroactive B/E pair on a synthetic lane — for events whose
        duration is only known after the fact (XLA compiles; the fedslo
        request span tree emitted at request finish).  ``end_s_ago``
        shifts the pair back so finish-time emission can place child
        phases (queue/prefill/decode) at their true host-clock offsets;
        ``None``-valued args are dropped, mirroring ``begin``."""
        if not self.enabled:
            return
        ts1 = max(self._ts() - float(end_s_ago) * 1e6, 0.0)
        ts0 = max(ts1 - float(duration_s) * 1e6, 0.0)
        base = {"name": name, "pid": self._pid, "tid": tid, "cat": cat,
                "host": self.host}
        b: Dict[str, Any] = {**base, "ph": "B", "ts": ts0}
        b["args"] = dict(
            {k: v for k, v in args.items() if v is not None},
            span_id=trace_context.new_span_id())
        e: Dict[str, Any] = {"name": name, "ph": "E", "ts": ts1,
                             "pid": self._pid, "tid": tid,
                             "host": self.host}
        with self._lock:
            self._events.extend((b, e))
            self._dirty = True
            agg = self._span_agg.setdefault(name, [0, 0.0])
            agg[0] += 1
            agg[1] += float(duration_s)

    # -- counters ----------------------------------------------------------
    def counter(self, name: str, value: float, **args):
        """Gauge-style counter sample (Chrome ``C`` event)."""
        if not self.enabled:
            return
        a: Dict[str, Any] = {"value": value}
        a.update(args)
        ev = {"name": name, "ph": "C", "ts": self._ts(), "pid": self._pid,
              "tid": threading.get_ident(), "host": self.host, "args": a}
        with self._lock:
            self._events.append(ev)
            self._dirty = True
            try:
                self._counters[name] = float(value)
            except (TypeError, ValueError):
                pass

    def add_bytes(self, name: str, n: int):
        """Cumulative byte counter (device_put/get probes)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "C", "ts": self._ts(), "pid": self._pid,
              "tid": threading.get_ident(), "host": self.host}
        with self._lock:
            total = self._counters.get(name, 0.0) + float(n)
            self._counters[name] = total
            ev["args"] = {"value": total}
            self._events.append(ev)
            self._dirty = True

    def round_obs(self, round_idx: int, round_time_s: float,
                  obs: Dict[str, float]):
        """One per-round device-telemetry record.  Called from the driver's
        existing log-round flush with ALREADY-materialized host floats —
        the tracer itself never syncs the device."""
        if not self.enabled:
            return
        args: Dict[str, Any] = {"round": int(round_idx),
                                "round_time_s": float(round_time_s)}
        for k, v in obs.items():
            args[k] = float(v)
        ev = {"name": "obs.round", "ph": "C", "ts": self._ts(),
              "pid": self._pid, "tid": threading.get_ident(),
              "host": self.host, "args": args}
        with self._lock:
            self._events.append(ev)
            self._dirty = True

    # -- export ------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        """Snapshot: ts-sorted events with synthesized ends for any span
        still open, so every B has a matching E."""
        with self._lock:
            evs = list(self._events)
            open_copy = {tid: list(st) for tid, st in self._open.items()
                         if st}
        ts = self._ts()
        for tid, stack in open_copy.items():
            for name, _t0, _sid in reversed(stack):
                evs.append({"name": name, "ph": "E", "ts": ts,
                            "pid": self._pid, "tid": tid,
                            "host": self.host,
                            "args": {"synthesized_end": True}})
        evs.sort(key=lambda e: e.get("ts", 0.0))
        return evs

    def process_label(self) -> str:
        return self.label or f"{self.host}:{self._pid}"

    def export_chrome(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Chrome trace-event JSON object; written to ``path`` (or the
        configured default path) when one is given.  ``otherData``
        carries the process identity + the unix clock anchor ``fedtrace
        merge`` aligns multi-process captures on."""
        # identity/clock anchor snapshot under the tracer lock: a round
        # flush racing reset() (or an end() bumping dropped_ends) must not
        # tear the (trace_id, origin) pair the multi-process merge aligns
        # on.  Taken BEFORE events(), which acquires the lock itself.
        with self._lock:
            other = {"exporter": "fedml_tpu.obs",
                     "dropped_ends": self.dropped_ends,
                     "host": self.host, "pid": self._pid,
                     "label": self.process_label(),
                     "trace_id": self.trace_id,
                     "origin_unix_us": self._origin_unix_us}
        trace = {
            "traceEvents": [
                {"name": "process_name", "ph": "M", "ts": 0.0,
                 "pid": self._pid, "tid": 0,
                 "args": {"name": self.process_label()}},
                {"name": "thread_name", "ph": "M", "ts": 0.0,
                 "pid": self._pid, "tid": COMPILE_TID,
                 "args": {"name": "graph-capture"}},
            ] + self.events(),
            "displayTimeUnit": "ms",
            "otherData": other,
        }
        path = path or self.path
        if path:
            with open(path, "w") as fh:
                json.dump(trace, fh)
            with self._lock:
                self._dirty = False
        return trace

    def close(self):
        """Flush the trace to ``path`` if anything new was recorded.
        Idempotent — safe from ``atexit``, a crash handler, AND a normal
        driver exit in any order; a silo process that dies mid-round
        still leaves a mergeable partial trace (open spans get
        synthesized ends)."""
        if not self.path:
            return
        with self._lock:
            if not self._dirty:
                return
        try:
            self.export_chrome(self.path)
        except OSError:  # interpreter teardown may have lost the dir
            pass

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "spans": {n: {"count": int(c), "total_s": t}
                          for n, (c, t) in sorted(self._span_agg.items())},
                "counters": dict(self._counters),
                "dropped_ends": self.dropped_ends,
            }

    def export_prometheus(self, path: Optional[str] = None) -> str:
        """Prometheus text-format aggregate of span totals + counters.

        Span / counter names ride as label VALUES (escaped — names like
        ``serve.requests.cohort-"1"`` are data here, not metric names),
        and the metric names themselves pass ``sanitize_metric_name`` so
        every emitted line survives a real Prometheus parser
        (round-tripped in tests via
        :func:`~fedml_tpu.obs.metricsd.parse_prometheus_text`)."""
        s = self.summary()
        m_total = sanitize_metric_name("fedtrace_span_seconds_total")
        m_count = sanitize_metric_name("fedtrace_span_count")
        m_gauge = sanitize_metric_name("fedtrace_counter")
        lines = [f"# TYPE {m_total} counter",
                 f"# TYPE {m_count} counter",
                 f"# TYPE {m_gauge} gauge"]
        for name, row in s["spans"].items():
            lbl = escape_label_value(name)
            lines.append(f'{m_total}{{name="{lbl}"}} '
                         f'{row["total_s"]:.9f}')
            lines.append(f'{m_count}{{name="{lbl}"}} {row["count"]}')
        for name, v in sorted(s["counters"].items()):
            lines.append(f'{m_gauge}{{name="{escape_label_value(name)}"}} '
                         f'{v:g}')
        text = "\n".join(lines) + "\n"
        if path:
            with open(path, "w") as fh:
                fh.write(text)
        return text


# -- global tracer ---------------------------------------------------------
_TRACER = Tracer()
_hooks_uninstall = None
_atexit_registered = False


def get_tracer() -> Tracer:
    return _TRACER


def trace_enabled() -> bool:
    return _TRACER.enabled


def configure(enabled: Optional[bool] = None, path: Optional[str] = None,
              reset: bool = False, hooks: bool = True,
              label: Optional[str] = None,
              jax_hooks: bool = False) -> Tracer:
    """Configure the global tracer.

    Enabling with ``hooks`` subscribes the tracer to :mod:`.torchhooks`
    (CUDA-graph captures, explicit host↔device byte counts); disabling
    unsubscribes it.  The hooks never add a transfer, a sync or a capture:
    ``TorchRuntimeAudit`` counts are equal between traced and untraced
    runs (``tests/test_torch_obs_engines.py``).

    ``label`` names this process's lane on a merged multi-process
    timeline ("server", "silo2", ...).  Enabling with a ``path`` also
    registers an (idempotent) atexit flush, so a process that exits —
    cleanly or via an uncaught exception — still leaves a mergeable
    trace file behind.  ``jax_hooks=True`` (the JAX package's compile and
    transfer hooks) raises ``NotImplementedError``: the port has no jax.
    """
    global _hooks_uninstall, _atexit_registered
    if jax_hooks:
        raise NotImplementedError(
            "obs.configure(jax_hooks=True): the jax compile and transfer "
            "hooks are not ported (the port runs no jax; hooks=True "
            "installs the port's own)")
    tr = _TRACER
    if path is not None:
        tr.path = path
    if label is not None:
        tr.label = label
    if reset:
        tr.reset()
    if enabled is None:
        return tr
    if enabled and not tr.enabled:
        tr.enabled = True
        if not _atexit_registered:
            atexit.register(tr.close)
            _atexit_registered = True
        if hooks and _hooks_uninstall is None:
            from . import torchhooks
            _hooks_uninstall = torchhooks.install_tracer_hooks(tr)
    elif not enabled and tr.enabled:
        tr.enabled = False
        if _hooks_uninstall is not None:
            _hooks_uninstall()
            _hooks_uninstall = None
    return tr


def tree_nbytes(x) -> int:
    """Total buffer bytes across the array leaves of nested dicts, lists
    and tuples (numpy arrays and tensors by ``nbytes``; raw ``bytes``
    leaves — fedwire chunk frames — at their length)."""
    if isinstance(x, dict):
        return sum(tree_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(tree_nbytes(v) for v in x)
    if isinstance(x, (bytes, bytearray)):
        return len(x)
    return int(getattr(x, "nbytes", 0) or 0)
