"""fedslo native histograms — fixed-boundary, log-bucketed, mergeable.

A stdlib copy of ``fedml_tpu.obs.histogram``, held to it on the same
inputs by ``tests/test_torch_obs_stdlib.py``.

The serving tier's latency telemetry was gauge-shaped (``serve.latency_
p99_ms`` computed by one load harness over one engine): correct for a
single stream, useless for a fleet — percentiles do not average, and the
per-adapter counter *names* (``serve.requests.<adapter>``) grew one
metric series per registered adapter (a cardinality bug).  This
module fixes both with the Prometheus classic-histogram contract:

- **Fixed log-spaced boundaries.**  Every engine in a fleet shares the
  same compiled-in bucket edges, so two engines' histograms merge by
  plain bucket-wise addition — the only aggregation that keeps fleet
  percentiles correct (``tools/serve_load.py --multi``).
- **``_bucket``/``_sum``/``_count`` exposition.**  Rendered onto the
  existing ``/metrics`` text dump, cumulative ``le`` buckets ending at
  ``+Inf``, parseable by a real Prometheus scraper and round-tripped by
  :func:`~fedml_tpu_torch.obs.metricsd.parse_prometheus_text`.
- **Bounded labels.**  Per-adapter series go through
  :class:`BoundedLabels`: the first K distinct adapters (K ≈ top-K by
  traffic under a Zipf mix, since heavy adapters arrive first and keep
  arriving) get their own label; everything past K collapses into
  ``other``.  Series count is bounded by construction, not by hoping the
  adapter population stays small.
- **Host floats only.**  ``record()`` takes already-materialized host
  values on the engine/HTTP threads; nothing here may ever touch a
  traced value (``fedlint`` jit-host-sync flags histogram sinks fed
  traced arguments, same as tracer/health sinks).

Quantile estimation (:func:`quantile_from_buckets`) is the standard
linear-interpolation-within-bucket estimate; its error is bounded by one
bucket width, which is the acceptance tolerance the fleet-merge bench
pins (``bench.py --serve-slo``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .tracer import escape_label_value, sanitize_metric_name

#: the overflow label every adapter past the cap collapses into
OVERFLOW_LABEL = "other"


def log_boundaries(lo: float, hi: float, per_decade: int = 5
                   ) -> Tuple[float, ...]:
    """Log₁₀-spaced bucket upper bounds from ``lo`` up to (at least)
    ``hi``.  Rounded to 6 significant digits so the rendered ``le``
    strings are byte-identical across hosts — merge keys on them."""
    if not (lo > 0 and hi > lo and per_decade >= 1):
        raise ValueError(f"bad boundary spec lo={lo} hi={hi} "
                         f"per_decade={per_decade}")
    out: List[float] = []
    i = 0
    while True:
        b = float(f"{lo * 10 ** (i / per_decade):.6g}")
        out.append(b)
        if b >= hi:
            return tuple(out)
        i += 1


#: latency-shaped quantities (seconds): 1 ms … 60 s, 5 buckets/decade
LATENCY_BOUNDARIES_S = log_boundaries(0.001, 60.0, per_decade=5)
#: rate-shaped quantities (tokens/s): 1 … 10k, 3 buckets/decade
RATE_BOUNDARIES = log_boundaries(1.0, 10000.0, per_decade=3)


def format_le(bound: float) -> str:
    """Canonical ``le`` label value for a bucket bound (``+Inf`` for the
    overflow bucket)."""
    if bound == float("inf"):
        return "+Inf"
    return f"{bound:.6g}"


class BoundedLabels:
    """First-K label minting with an ``other`` overflow lane.

    Tracks cumulative traffic per *raw* name (host dict — exact, cheap)
    while bounding the *minted* label set: the first ``k`` distinct
    names each get their own series; later names resolve to
    :data:`OVERFLOW_LABEL`.  Under the Zipf-mix traffic serving actually
    sees, arrival order ≈ traffic order, so first-K ≈ top-K by traffic;
    a label once minted never moves (a re-ranking mid-run would break
    the monotone-bucket contract merges rely on).  ``top()`` reports the
    exact traffic ranking for dashboards regardless of minting."""

    def __init__(self, k: int = 8):
        self.k = max(1, int(k))
        self._minted: Dict[str, bool] = {}
        self._counts: Dict[str, int] = {}      # raw name -> requests
        self._label_counts: Dict[str, int] = {}  # label -> requests
        self._lock = threading.Lock()

    def resolve(self, name: str, count: bool = True) -> Tuple[str, int]:
        """Label for ``name`` plus that label's cumulative request
        count; ``count=True`` (the submit path) also charges one
        request to it."""
        name = str(name)
        with self._lock:
            if name in self._minted:
                label = name
            elif len(self._minted) < self.k:
                self._minted[name] = True
                label = name
            else:
                label = OVERFLOW_LABEL
            if count:
                self._counts[name] = self._counts.get(name, 0) + 1
                self._label_counts[label] = \
                    self._label_counts.get(label, 0) + 1
            return label, self._label_counts.get(label, 0)

    def top(self, n: Optional[int] = None) -> List[Tuple[str, int]]:
        """Exact per-raw-name traffic ranking (not capped)."""
        with self._lock:
            rows = sorted(self._counts.items(),
                          key=lambda kv: (-kv[1], kv[0]))
        return rows if n is None else rows[:n]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


class Histogram:
    """One fixed-boundary histogram family with bounded labels.

    Thread-safe; all methods take host floats.  ``record`` /
    ``observe_latency`` are the fedlint-recognized sink names — never
    feed them a traced value from jit-reachable code."""

    def __init__(self, name: str, boundaries: Sequence[float] =
                 LATENCY_BOUNDARIES_S, label_key: str = "adapter",
                 labels: Optional[BoundedLabels] = None,
                 max_labels: int = 8):
        self.name = sanitize_metric_name(name)
        self.boundaries = tuple(float(b) for b in boundaries)
        if list(self.boundaries) != sorted(set(self.boundaries)):
            raise ValueError(f"{name}: boundaries must be strictly "
                             "increasing")
        self.label_key = label_key
        self.labels = labels if labels is not None \
            else BoundedLabels(max_labels)
        # label -> [per-bucket counts (len = len(bounds)+1 incl +Inf),
        #           sum, count]
        self._series: Dict[str, List[Any]] = {}
        self._lock = threading.Lock()

    def _bucket_index(self, value: float) -> int:
        lo, hi = 0, len(self.boundaries)
        while lo < hi:                     # first bound >= value
            mid = (lo + hi) // 2
            if value <= self.boundaries[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo                          # == len(boundaries) -> +Inf

    def record(self, value: float, label: Optional[str] = None) -> str:
        """Observe one host float; returns the (possibly capped) label
        the sample landed under."""
        value = float(value)
        lbl = (self.labels.resolve(label, count=False)[0]
               if label is not None else "base")
        idx = self._bucket_index(value)
        with self._lock:
            row = self._series.get(lbl)
            if row is None:
                row = [[0] * (len(self.boundaries) + 1), 0.0, 0]
                self._series[lbl] = row
            row[0][idx] += 1
            row[1] += value
            row[2] += 1
        return lbl

    #: alias — the latency-flavored sink name fedlint also knows
    observe_latency = record

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """``{label: {"buckets": [(le_str, cumulative)], "sum", "count"}}``
        — the same shape :func:`buckets_from_samples` parses back out of
        an exposition, so in-process and scraped paths share the
        quantile/merge code."""
        with self._lock:
            series = {lbl: ([list(row[0])], row[1], row[2])
                      for lbl, row in self._series.items()}
        out: Dict[str, Dict[str, Any]] = {}
        for lbl, (counts_w, total, n) in series.items():
            counts = counts_w[0]
            cum, cbuckets = 0, []
            for b, c in zip(self.boundaries, counts):
                cum += c
                cbuckets.append((format_le(b), cum))
            cbuckets.append((format_le(float("inf")), cum + counts[-1]))
            out[lbl] = {"buckets": cbuckets, "sum": total, "count": n}
        return out

    def merge_from(self, other: "Histogram") -> None:
        """Bucket-wise addition (fleet aggregation). Boundaries must be
        identical — that is the fixed-boundary contract."""
        if other.boundaries != self.boundaries:
            raise ValueError(f"{self.name}: cannot merge histograms with "
                             "different boundaries")
        with other._lock:
            rows = {lbl: [list(r[0]), r[1], r[2]]
                    for lbl, r in other._series.items()}
        with self._lock:
            for lbl, (counts, total, n) in rows.items():
                row = self._series.get(lbl)
                if row is None:
                    self._series[lbl] = [counts, total, n]
                else:
                    row[0] = [a + b for a, b in zip(row[0], counts)]
                    row[1] += total
                    row[2] += n

    def quantile(self, q: float, label: Optional[str] = None
                 ) -> Optional[float]:
        """Estimated quantile over one label (or all labels merged)."""
        snap = self.snapshot()
        if label is not None:
            entry = snap.get(label)
            return quantile_from_buckets(entry, q) if entry else None
        merged = merge_bucket_entries(list(snap.values()))
        return quantile_from_buckets(merged, q) if merged else None

    def render_prometheus(self) -> str:
        """Classic-histogram text exposition: cumulative ``_bucket``
        series ending at ``+Inf``, plus ``_sum``/``_count`` — every line
        shaped to survive :func:`parse_prometheus_text`."""
        snap = self.snapshot()
        if not snap:
            return ""
        lines = [f"# TYPE {self.name} histogram"]
        key = sanitize_metric_name(self.label_key)
        for lbl in sorted(snap):
            entry = snap[lbl]
            esc = escape_label_value(lbl)
            for le, cum in entry["buckets"]:
                lines.append(f'{self.name}_bucket{{{key}="{esc}",'
                             f'le="{le}"}} {cum}')
            lines.append(f'{self.name}_sum{{{key}="{esc}"}} '
                         f'{entry["sum"]:.9g}')
            lines.append(f'{self.name}_count{{{key}="{esc}"}} '
                         f'{entry["count"]}')
        return "\n".join(lines) + "\n"


# -- bucket-entry algebra (shared by in-process + scraped paths) -----------

def _le_key(le: str) -> float:
    return float("inf") if le == "+Inf" else float(le)


def merge_bucket_entries(entries: Iterable[Optional[Dict[str, Any]]]
                         ) -> Optional[Dict[str, Any]]:
    """Merge ``snapshot()``-shaped entries by bucket addition.  Entries
    must share the same ``le`` grid (fixed boundaries); ``None`` entries
    are skipped."""
    acc: Optional[Dict[str, Any]] = None
    for e in entries:
        if e is None:
            continue
        if acc is None:
            acc = {"buckets": [list(b) for b in e["buckets"]],
                   "sum": float(e["sum"]), "count": int(e["count"])}
            continue
        if [b[0] for b in acc["buckets"]] != [b[0] for b in e["buckets"]]:
            raise ValueError("cannot merge histograms with different "
                             "bucket boundaries")
        for row, (_le, cum) in zip(acc["buckets"], e["buckets"]):
            row[1] += cum
        acc["sum"] += float(e["sum"])
        acc["count"] += int(e["count"])
    if acc is not None:
        acc["buckets"] = [tuple(b) for b in acc["buckets"]]
    return acc


def diff_bucket_entries(after: Dict[str, Any],
                        before: Optional[Dict[str, Any]]
                        ) -> Dict[str, Any]:
    """Windowed delta between two scrapes of the same cumulative
    histogram (the Prometheus ``rate()`` discipline): subtract
    ``before``'s buckets/sum/count from ``after``'s.  ``before=None``
    returns ``after`` unchanged (first scrape); clamps at zero so a
    counter reset degrades to the raw ``after`` values rather than
    going negative."""
    if before is None:
        return after
    if [b[0] for b in after["buckets"]] != [b[0] for b in
                                            before["buckets"]]:
        raise ValueError("cannot diff histograms with different "
                         "bucket boundaries")
    if after["count"] < before["count"]:   # counter reset between scrapes
        return after
    return {"buckets": [(le, max(cum - b_cum, 0)) for (le, cum),
                        (_le, b_cum) in zip(after["buckets"],
                                            before["buckets"])],
            "sum": max(float(after["sum"]) - float(before["sum"]), 0.0),
            "count": int(after["count"]) - int(before["count"])}


def quantile_from_buckets(entry: Dict[str, Any], q: float
                          ) -> Optional[float]:
    """Linear-interpolation quantile estimate from cumulative buckets
    (the Prometheus ``histogram_quantile`` rule): error ≤ one bucket
    width; samples in the ``+Inf`` bucket clamp to the last finite
    bound."""
    buckets = sorted(entry["buckets"], key=lambda b: _le_key(b[0]))
    total = buckets[-1][1] if buckets else 0
    if total <= 0:
        return None
    rank = max(0.0, min(1.0, float(q))) * total
    prev_le, prev_cum = 0.0, 0
    for le, cum in buckets:
        bound = _le_key(le)
        if cum >= rank:
            if bound == float("inf"):
                return prev_le          # clamp: last finite bound
            if cum == prev_cum:
                return bound
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_le + (bound - prev_le) * frac
        prev_le, prev_cum = bound, cum
    return prev_le


def bucket_width_at(entry: Dict[str, Any], value: float) -> float:
    """Width of the bucket containing ``value`` — the estimate's error
    bound at that point (the fleet-merge acceptance tolerance)."""
    prev = 0.0
    for le, _cum in sorted(entry["buckets"], key=lambda b: _le_key(b[0])):
        bound = _le_key(le)
        if bound == float("inf"):
            return float("inf")
        if value <= bound:
            return bound - prev
        prev = bound
    return float("inf")


def buckets_from_samples(samples: Iterable[Tuple[str, Dict[str, str],
                                                 float]],
                         name: str, label_key: str = "adapter"
                         ) -> Dict[str, Dict[str, Any]]:
    """Reassemble histogram entries out of
    :func:`~fedml_tpu_torch.obs.metricsd.parse_prometheus_text` output:
    ``{label: {"buckets": [(le, cum)], "sum", "count"}}`` — the inverse
    of :meth:`Histogram.render_prometheus`."""
    name = sanitize_metric_name(name)
    out: Dict[str, Dict[str, Any]] = {}
    for metric, labels, value in samples:
        if not metric.startswith(name + "_"):
            continue
        lbl = labels.get(label_key, "base")
        entry = out.setdefault(lbl, {"buckets": [], "sum": 0.0,
                                     "count": 0})
        if metric == name + "_bucket" and "le" in labels:
            entry["buckets"].append((labels["le"], int(value)))
        elif metric == name + "_sum":
            entry["sum"] = float(value)
        elif metric == name + "_count":
            entry["count"] = int(value)
    for entry in out.values():
        entry["buckets"].sort(key=lambda b: _le_key(b[0]))
    return out


# -- the serving bundle -----------------------------------------------------

#: (attr, metric name, boundaries) for every request-lifecycle quantity
SERVE_HISTOGRAMS = (
    ("ttft", "serve_ttft_seconds", LATENCY_BOUNDARIES_S),
    ("e2e", "serve_e2e_seconds", LATENCY_BOUNDARIES_S),
    ("queue_wait", "serve_queue_wait_seconds", LATENCY_BOUNDARIES_S),
    ("prefill", "serve_prefill_seconds", LATENCY_BOUNDARIES_S),
    ("decode", "serve_decode_seconds", LATENCY_BOUNDARIES_S),
    ("decode_tok_s", "serve_decode_tok_per_s", RATE_BOUNDARIES),
)


class ServeHistograms:
    """The engine's request-lifecycle histogram set, one shared
    :class:`BoundedLabels` across all six families so "top-K adapters"
    means the same adapters everywhere."""

    def __init__(self, max_labels: int = 8):
        self.labels = BoundedLabels(max_labels)
        for attr, metric, bounds in SERVE_HISTOGRAMS:
            setattr(self, attr, Histogram(metric, bounds,
                                          labels=self.labels))

    def record_request(self, label: str, *, queue_s: float,
                       prefill_s: float, e2e_s: float,
                       ttft_s: Optional[float] = None,
                       decode_s: Optional[float] = None,
                       output_tokens: int = 0) -> None:
        """One finished request's host-measured phase breakdown."""
        self.queue_wait.record(queue_s, label)
        self.prefill.record(prefill_s, label)
        self.e2e.record(e2e_s, label)
        if ttft_s is not None:
            self.ttft.record(ttft_s, label)
        if decode_s is not None:
            self.decode.record(decode_s, label)
            if decode_s > 0 and output_tokens > 1:
                # first token belongs to prefill; rate covers the rest
                self.decode_tok_s.record((output_tokens - 1) / decode_s,
                                         label)

    def histograms(self) -> List[Histogram]:
        return [getattr(self, attr) for attr, _m, _b in SERVE_HISTOGRAMS]

    def render_prometheus(self) -> str:
        return "".join(h.render_prometheus() for h in self.histograms())

    def merge_from(self, other: "ServeHistograms") -> None:
        for attr, _m, _b in SERVE_HISTOGRAMS:
            getattr(self, attr).merge_from(getattr(other, attr))
