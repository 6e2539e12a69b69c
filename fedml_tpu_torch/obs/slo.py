"""fedslo objective rules — multi-window, multi-burn-rate SLO alerts.

A stdlib copy of ``fedml_tpu.obs.slo``, held to it on the same
inputs by ``tests/test_torch_obs_stdlib.py``.

The fedmon rule schema (:mod:`.health`) is point-in-time: ``metric >
max`` ⇒ degraded.  That is the wrong shape for latency objectives — "p99
TTFT < 200 ms" violated for one scrape interval is noise, violated
steadily for an hour is an incident — so this module adds
*objective-style* rules evaluated the way SRE burn-rate alerting does:

- An **objective** is ``{metric, threshold, compliance}``: "``metric``
  stays ≤ ``threshold`` for at least ``compliance`` of requests" (p99 <
  200 ms ⇔ compliance 0.99 at threshold 0.2 s).  The error *budget* is
  ``1 - compliance``.
- Each request is **good** (≤ threshold) or **bad**; the **burn rate**
  over a window is ``bad_fraction / budget`` — burn 1.0 spends the
  budget exactly at the compliance horizon, burn 14.4 spends a 30-day
  budget in 2 days.
- An alert fires only when BOTH windows of a pair burn (the long window
  proves it is sustained, the short window proves it is still
  happening, so recovered incidents stop alerting fast):
  **fast** = 5 m + 1 h at burn ≥ 14.4 (⇒ ``unhealthy``),
  **slow** = 30 m + 6 h at burn ≥ 6 (⇒ ``degraded``).

``time_scale`` compresses the wall-clock windows (benches and tests
replay hours of traffic in seconds); the *shape* of the policy is what
is under test, not the literal hour.

Rules load through :func:`~fedml_tpu_torch.obs.health.load_slo_rules` (the
schema gains an ``objective`` key) and evaluate through
:func:`~fedml_tpu_torch.obs.health.evaluate_slos` when the caller provides the
matching :class:`ObjectiveWindow` streams.  Pure stdlib, host floats
only — same contract as the tracer.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .histogram import _le_key

#: the multi-window / multi-burn-rate alert policy (SRE workbook ch.5):
#: (name, short window s, long window s, burn threshold, verdict)
BURN_WINDOWS: Tuple[Tuple[str, float, float, float, str], ...] = (
    ("fast", 300.0, 3600.0, 14.4, "unhealthy"),
    ("slow", 1800.0, 21600.0, 6.0, "degraded"),
)


def validate_objective(obj: Dict[str, Any], where: str = "rule") -> None:
    """Schema check for an ``objective`` block: ``metric`` (histogram /
    stream name), ``threshold`` (good ≤ threshold), ``compliance`` in
    (0, 1) (or ``percentile`` — same number, either spelling)."""
    if not isinstance(obj, dict):
        raise ValueError(f"{where}: 'objective' must be a mapping, got "
                         f"{obj!r}")
    if "metric" not in obj:
        raise ValueError(f"{where}: objective missing 'metric': {obj!r}")
    if "threshold" not in obj:
        raise ValueError(f"{where}: objective missing 'threshold': "
                         f"{obj!r}")
    comp = obj.get("compliance", obj.get("percentile"))
    if comp is None:
        raise ValueError(f"{where}: objective needs 'compliance' (or "
                         f"'percentile'): {obj!r}")
    comp = float(comp)
    if not 0.0 < comp < 1.0:
        raise ValueError(f"{where}: compliance must be in (0, 1), got "
                         f"{comp}")


def objective_budget(obj: Dict[str, Any]) -> float:
    comp = float(obj.get("compliance", obj.get("percentile")))
    return 1.0 - comp


class ObjectiveWindow:
    """Good/bad event stream for ONE objective, answering burn-rate
    queries over arbitrary trailing windows.

    Events are ``(t, total, bad)`` batches appended by ``observe`` (one
    request) or ``ingest_counts`` (a scrape delta); windows scan the
    tail — request volumes here are per-engine host streams, thousands
    not billions, so a plain list beats a ring of pre-aggregated
    buckets.  A ``max_events`` cap bounds memory for soak runs."""

    def __init__(self, objective: Dict[str, Any],
                 time_scale: float = 1.0, max_events: int = 200_000,
                 clock=time.monotonic):
        validate_objective(objective)
        self.objective = dict(objective)
        self.metric = str(objective["metric"])
        self.threshold = float(objective["threshold"])
        self.budget = objective_budget(objective)
        self.time_scale = float(time_scale)
        self.max_events = int(max_events)
        self._clock = clock
        self._events: List[Tuple[float, int, int]] = []

    # -- ingest -------------------------------------------------------------
    def observe(self, value: float, t: Optional[float] = None) -> bool:
        """One request's measured value; returns True when good."""
        good = float(value) <= self.threshold
        self._append(t, 1, 0 if good else 1)
        return good

    def ingest_counts(self, total: int, bad: int,
                      t: Optional[float] = None) -> None:
        """A pre-counted batch (scrape-delta path)."""
        if total > 0:
            self._append(t, int(total), int(bad))

    def ingest_bucket_entry(self, entry: Dict[str, Any],
                            t: Optional[float] = None) -> None:
        """Count good/bad straight off a histogram snapshot entry
        (``{"buckets": [(le, cum)], "count": n}``): good = cumulative
        count at the smallest bound ≥ threshold — bucket-resolution
        evaluation, conservative by at most one bucket."""
        good = 0
        for le, cum in sorted(entry["buckets"],
                              key=lambda b: _le_key(b[0])):
            if _le_key(le) >= self.threshold:
                good = cum
                break
        total = int(entry["count"])
        self.ingest_counts(total, total - int(good), t=t)

    def _append(self, t: Optional[float], total: int, bad: int) -> None:
        t = self._clock() if t is None else float(t)
        self._events.append((t, total, bad))
        if len(self._events) > self.max_events:
            # drop the oldest half — windows only read the tail
            del self._events[: self.max_events // 2]

    # -- queries ------------------------------------------------------------
    def counts(self, window_s: float, now: Optional[float] = None
               ) -> Tuple[int, int]:
        now = self._clock() if now is None else float(now)
        lo = now - float(window_s) * self.time_scale
        total = bad = 0
        for t, n, b in reversed(self._events):
            if t < lo:
                break
            total += n
            bad += b
        return total, bad

    def burn_rate(self, window_s: float, now: Optional[float] = None
                  ) -> Optional[float]:
        """``bad_fraction / budget`` over the trailing window; ``None``
        with no traffic in the window (no data is not an alert)."""
        total, bad = self.counts(window_s, now=now)
        if total == 0:
            return None
        return (bad / total) / self.budget if self.budget > 0 \
            else float("inf") if bad else 0.0

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Multi-window verdict for this one objective: worst firing
        pair wins; a pair fires only when BOTH its windows burn."""
        now = self._clock() if now is None else float(now)
        rows: List[Dict[str, Any]] = []
        status = "ok"
        order = ("ok", "degraded", "unhealthy")
        for name, short_s, long_s, thresh, verdict in BURN_WINDOWS:
            b_short = self.burn_rate(short_s, now=now)
            b_long = self.burn_rate(long_s, now=now)
            firing = (b_short is not None and b_long is not None
                      and b_short >= thresh and b_long >= thresh)
            rows.append({"window": name, "short_s": short_s,
                         "long_s": long_s, "burn_threshold": thresh,
                         "burn_short": b_short, "burn_long": b_long,
                         "firing": firing})
            if firing and order.index(verdict) > order.index(status):
                status = verdict
        total, bad = self.counts(BURN_WINDOWS[-1][2], now=now)
        return {"metric": self.metric, "threshold": self.threshold,
                "budget": self.budget, "status": status,
                "windows": rows, "total": total, "bad": bad,
                "bad_fraction": (bad / total) if total else None}


def evaluate_objective_rules(rules: Iterable[Dict[str, Any]],
                             objectives: Dict[str, "ObjectiveWindow"],
                             now: Optional[float] = None
                             ) -> List[Dict[str, Any]]:
    """Burn-rate checks for every objective-style rule that has a live
    window stream; rules without one report ``skipped`` (a train-only
    process is not degraded for lacking serving streams)."""
    checks: List[Dict[str, Any]] = []
    for rule in rules:
        obj = rule.get("objective")
        if obj is None:
            continue
        name = rule.get("name", obj.get("metric", "objective"))
        win = objectives.get(name) or objectives.get(obj.get("metric"))
        row: Dict[str, Any] = {"name": name, "objective": dict(obj)}
        if win is None:
            row["status"] = "skipped"
        else:
            row.update(win.evaluate(now=now))
            row["name"] = name
        checks.append(row)
    return checks


def windows_for_rules(rules: Iterable[Dict[str, Any]],
                      time_scale: float = 1.0,
                      clock=time.monotonic
                      ) -> Dict[str, ObjectiveWindow]:
    """One :class:`ObjectiveWindow` per objective rule, keyed by rule
    name — the streams a serving driver feeds per finished request and
    hands to ``evaluate_slos(..., objectives=...)``."""
    out: Dict[str, ObjectiveWindow] = {}
    for rule in rules:
        obj = rule.get("objective")
        if obj is None:
            continue
        name = rule.get("name", obj.get("metric", "objective"))
        out[name] = ObjectiveWindow(obj, time_scale=time_scale,
                                    clock=clock)
    return out
