"""fedmon live export — a threaded /metrics · /healthz · /debug/health
endpoint over the global tracer + :class:`~fedml_tpu_torch.obs.health.HealthMonitor`
(a copy of ``fedml_tpu.obs.metricsd``, over the port's tracer and health).

Design constraints (mirror the tracer's):

- **Read-only and off the hot path.**  The HTTP threads only snapshot
  host-side aggregates (tracer counters / span totals, fedmon gauges);
  they never touch a device value, never block the train loop beyond the
  tracer's existing lock.
- **Prometheus text format, for real parsers.**  The tracer's historical
  dump emitted unescaped label values (adapter names and span args with
  ``"`` broke scrapes); export here goes through
  :func:`sanitize_metric_name` / :func:`escape_label_value`, and
  :func:`parse_prometheus_text` is the round-trip witness the unit tests
  and ``tools/serve_load.py --scrape-metrics`` both use.
- **Port discipline.**  ``port=0`` binds an ephemeral port (tests,
  bench); multi-process drivers pass ``port + rank`` so silo/worker
  ranks on one host never collide.  Loopback by default — the endpoint
  is unauthenticated.

``/healthz`` returns the declarative-SLO verdict (``ok | degraded |
unhealthy`` — HTTP 200 for ok/degraded, 503 for unhealthy) evaluated
over tracer counters merged with fedmon gauges; ``/debug/health``
returns the recent flag events as JSON.
"""

from __future__ import annotations

import json
import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from .health import DEFAULT_SLO_RULES, HealthMonitor, evaluate_slos
from .tracer import (Tracer, escape_label_value, get_tracer,
                     sanitize_metric_name)

log = logging.getLogger(__name__)


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(value: str) -> str:
    out, i = [], 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt,
                                                             "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_prometheus_text(text: str
                          ) -> List[Tuple[str, Dict[str, str], float]]:
    """Parse Prometheus text format into ``(metric, labels, value)``
    samples.  Strict about the sample shape (that is the point — the
    round-trip test feeds the tracer's own dump back through here), and
    raises ``ValueError`` on a malformed non-comment line."""
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: not a prometheus sample: "
                             f"{line!r}")
        name, labelstr, value = m.groups()
        labels: Dict[str, str] = {}
        if labelstr:
            consumed = 0
            for lm in _LABEL_RE.finditer(labelstr):
                labels[lm.group(1)] = _unescape(lm.group(2))
                consumed = lm.end()
            rest = labelstr[consumed:].strip().strip(",")
            if rest:
                raise ValueError(f"line {lineno}: bad label block "
                                 f"{labelstr!r}")
        samples.append((name, labels, float(value)))
    return samples


def prom_value(samples, metric: str, **labels) -> Optional[float]:
    """First sample matching ``metric`` whose labels include ``labels``."""
    for name, lbl, value in samples:
        if name == metric and all(lbl.get(k) == v
                                  for k, v in labels.items()):
            return value
    return None


def render_gauges(gauges: Dict[str, float],
                  metric: str = "fedmon_gauge") -> str:
    """Extra gauges (fedmon health plane) appended to the tracer dump —
    same escaped ``{name="..."}`` label convention."""
    lines = [f"# TYPE {sanitize_metric_name(metric)} gauge"]
    for name, v in sorted(gauges.items()):
        lines.append(f'{sanitize_metric_name(metric)}'
                     f'{{name="{escape_label_value(name)}"}} {v:g}')
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Threaded HTTP endpoint serving the fedmon surface.

    ``monitor`` is optional (a serving engine exports tracer counters
    only); ``slo_rules`` defaults to the monitor's rules, else
    :data:`~fedml_tpu_torch.obs.health.DEFAULT_SLO_RULES`."""

    def __init__(self, tracer: Optional[Tracer] = None,
                 monitor: Optional[HealthMonitor] = None,
                 slo_rules: Optional[List[Dict[str, Any]]] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 extra_text=None, objectives=None):
        self.tracer = tracer or get_tracer()
        self.monitor = monitor
        self.slo_rules = slo_rules
        self.host = host
        self.port = int(port)
        # fedslo extensions: ``extra_text`` — zero-arg callables whose
        # text appends to /metrics (the serving engine passes its
        # ServeHistograms exposition); ``objectives`` — rule-name →
        # ObjectiveWindow streams so /healthz evaluates burn-rate rules,
        # not just point checks
        self.extra_text = list(extra_text or [])
        self.objectives = objectives
        self._server: Optional[ThreadingHTTPServer] = None

    # -- payloads (also unit-testable without a socket) ---------------------
    def metrics_text(self) -> str:
        text = self.tracer.export_prometheus()
        if self.monitor is not None:
            text += render_gauges(self.monitor.gauges())
        for provider in self.extra_text:
            text += provider()
        return text

    def healthz(self) -> Dict[str, Any]:
        counters = self.tracer.summary()["counters"]
        if self.monitor is not None:
            rules = self.slo_rules or self.monitor.slo_rules
            metrics = dict(counters)
            metrics.update(self.monitor.gauges())
        else:
            rules = self.slo_rules or DEFAULT_SLO_RULES
            metrics = counters
        return evaluate_slos(rules, metrics, objectives=self.objectives)

    def debug_health(self) -> Dict[str, Any]:
        if self.monitor is None:
            return {"flagged": [], "recent_flags": [], "gauges": {}}
        return {"flagged": self.monitor.flag_details(),
                "recent_flags": self.monitor.recent_flags(),
                "gauges": self.monitor.gauges()}

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> int:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # no stderr chatter per scrape
                pass

            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        body = outer.metrics_text().encode()
                        ctype, code = ("text/plain; version=0.0.4", 200)
                    elif path == "/healthz":
                        v = outer.healthz()
                        body = json.dumps(v).encode()
                        ctype = "application/json"
                        code = 503 if v["status"] == "unhealthy" else 200
                    elif path == "/debug/health":
                        body = json.dumps(outer.debug_health()).encode()
                        ctype, code = ("application/json", 200)
                    else:
                        body, ctype, code = (b"not found", "text/plain",
                                             404)
                except Exception as e:   # a broken scrape must not 500-loop
                    body = json.dumps({"error": repr(e)}).encode()
                    ctype, code = ("application/json", 500)
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        log.info("fedmon metrics endpoint on %s:%d (/metrics /healthz "
                 "/debug/health)", self.host, self.port)
        return self.port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


def start_from_args(args, monitor: Optional[HealthMonitor] = None,
                    rank: Optional[int] = None) -> Optional[MetricsServer]:
    """The drivers' one-liner: start an endpoint when ``args.metrics_port``
    is set (``0`` = ephemeral; nonzero ports offset by ``rank`` so the
    multi-process silo/async drivers' ranks never collide on one host).
    A bind failure degrades to a warning — monitoring must never kill
    training."""
    port = getattr(args, "metrics_port", None)
    if port is None or port is False:
        return None
    port = int(port)
    if port > 0:
        port += int(rank if rank is not None
                    else getattr(args, "rank", 0) or 0)
    rules = None
    slo_path = getattr(args, "health_slo_path", None)
    if slo_path and monitor is None:
        from .health import load_slo_rules
        rules = load_slo_rules(slo_path)
    server = MetricsServer(get_tracer(), monitor=monitor,
                           slo_rules=rules, port=port)
    try:
        server.start()
    except OSError as e:
        log.warning("fedmon: could not bind metrics endpoint on port %d "
                    "(%s); continuing without live export", port, e)
        return None
    return server
