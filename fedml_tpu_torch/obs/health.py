"""fedmon — host-side federation-health plane (anomaly / drift / SLOs).

A stdlib copy of ``fedml_tpu.obs.health``, held to it on the same
inputs by ``tests/test_torch_obs_stdlib.py``.

The engines compute fixed-shape per-client stat rows IN-TRACE (update L2
norm, cosine-to-cohort-mean, per-client loss delta, async staleness —
``core/federated.py::client_health_stats``) and return them through the
same metrics pytree the loss rides, so the tracer's zero-overhead
contract holds unchanged: tracing/health on adds ZERO host syncs, explicit
transfers, or steady-state compiles.  The round loop materializes the
rows at its EXISTING log-round flush and feeds them here.

This module is the pure host half — stdlib math only (no jax, no numpy
required; any float sequence works), so ``tools/fedtrace.py health`` can
reason about the same quantities offline:

- **Robust per-round z-scores** (median / MAD, with absolute MAD floors
  so a perfectly homogeneous cohort cannot manufacture infinite z) over
  the per-client stat stream.  Directionality encodes the attack
  signatures: a *scaled update* is an update-norm outlier ABOVE the
  cohort median (scored in log space, so "10x" means the same thing at
  every scale); a *label flip* points AWAY from the cohort-mean update
  (cosine far BELOW the median) and carries an elevated local loss.
- **Per-client EWM baselines** keyed by registered client id (a dict
  over OBSERVED ids, so 1M-registered fedstore runs cost memory
  proportional to the touched cohort set, not the id space).
- **Cohort-level drift**: EWM baselines of the round medians; a round
  whose median walks many floors away from its own baseline raises the
  drift score (the whole cohort moved — not an individual outlier).
- **Declarative SLO rules** (YAML or dicts) evaluated over the merged
  gauge set (tracer counters + fedmon gauges) into the ok / degraded /
  unhealthy verdict ``obs/metricsd.py`` serves on ``/healthz``.

Every per-round verdict is emitted as a ``health.verdict`` span plus
``health.*`` counters on the global tracer (host floats only — the
fedlint jit-host-sync rule flags ``health.observe/flag`` sinks fed a
traced value inside jit-reachable code, exactly like the tracer sinks).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence

from .tracer import get_tracer

#: stat fields every engine's in-trace rows carry (async adds staleness)
HEALTH_STAT_FIELDS = ("update_norm", "cosine", "loss_delta", "weight")


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def robust_z(vals: Sequence[float], floor: float) -> List[float]:
    """Per-element robust z-scores: ``(x - median) / (1.4826 * MAD)``
    with an absolute floor on the MAD scale.  The floor is the knob that
    keeps a *homogeneous* cohort honest — when every client agrees to
    within ``floor``, nobody is an outlier no matter how tight the
    spread."""
    med = _median(vals)
    mad = _median([abs(v - med) for v in vals])
    scale = max(1.4826 * mad, float(floor))
    return [(v - med) / scale for v in vals]


@dataclass
class HealthConfig:
    """Detector knobs (``args.health_*`` override the defaults).

    ``z_flag`` is the per-round robust-z magnitude that counts as full
    anomaly evidence; a client flags when its evidence EWM crosses 1.0
    after ``min_obs`` observations, or immediately at ``hard_z``.  The
    per-stat floors are ABSOLUTE robust-scale floors (log-norm units /
    cosine units / loss units)."""
    z_flag: float = 5.5
    hard_z: float = 20.0
    ewm_alpha: float = 0.6
    min_obs: int = 2
    clear_score: float = 0.25      # evidence EWM below this unflags
    norm_floor: float = 0.25       # log-space: ~= "within 1.28x is normal"
    cosine_floor: float = 0.08
    loss_floor: float = 0.25
    drift_alpha: float = 0.25
    drift_flag: float = 8.0
    drift_warmup: int = 3          # rounds before drift can fire
    recent: int = 256              # flag events kept for /debug/health


@dataclass
class _ClientBaseline:
    """Per-registered-client EWM state (small and dict-packed: the
    1M-registered case stores one of these per OBSERVED client)."""
    evidence: float = 0.0          # EWM of score / z_flag (1.0 == flag)
    score_last: float = 0.0
    obs: int = 0
    rounds: List[int] = field(default_factory=list)


class HealthMonitor:
    """Streaming anomaly + drift detector over per-client stat rows.

    Thread-safe: the driver observes from the train loop while
    ``obs/metricsd.py`` reads gauges from its HTTP threads."""

    def __init__(self, config: Optional[HealthConfig] = None,
                 slo_rules: Optional[List[Dict[str, Any]]] = None):
        self.config = config or HealthConfig()
        self.slo_rules = (DEFAULT_SLO_RULES if slo_rules is None
                          else slo_rules)
        self._lock = threading.Lock()
        self._clients: Dict[int, _ClientBaseline] = {}
        self._flagged: Dict[int, Dict[str, Any]] = {}
        self._flag_events: List[Dict[str, Any]] = []
        self._drift_base: Dict[str, float] = {}
        self._drift_score = 0.0
        self._drift_rounds = 0
        self._gauges: Dict[str, float] = {}
        self.rounds_observed = 0

    @classmethod
    def from_args(cls, args) -> "HealthMonitor":
        cfg = HealthConfig(
            z_flag=float(getattr(args, "health_z", 0.0) or
                         HealthConfig.z_flag),
            ewm_alpha=float(getattr(args, "health_ewm_alpha", 0.0) or
                            HealthConfig.ewm_alpha),
            min_obs=int(getattr(args, "health_min_obs", 0) or
                        HealthConfig.min_obs))
        rules = None
        slo_path = getattr(args, "health_slo_path", None)
        if slo_path:
            rules = load_slo_rules(slo_path)
        return cls(cfg, rules)

    # -- ingest -------------------------------------------------------------
    def observe_round(self, round_idx: int, client_ids: Sequence[int],
                      stats: Dict[str, Sequence[float]],
                      round_time_s: float = 0.0) -> Dict[str, Any]:
        """One round's materialized per-client stat rows.

        ``client_ids`` are the sampled REGISTERED ids (host ints — the
        driver's own sampling, never a device readback); ``stats`` maps
        :data:`HEALTH_STAT_FIELDS` (+ optional ``staleness``) to
        sequences at least ``len(client_ids)`` long (mesh engines pad the
        cohort axis — pad rows carry weight 0 and are dropped here).
        Returns the per-round verdict dict (also traced as the
        ``health.verdict`` span + ``health.*`` counters)."""
        tracer = get_tracer()
        with tracer.span("health.verdict", cat="health", round=round_idx):
            verdict = self._observe(round_idx, client_ids, stats,
                                    round_time_s)
        if tracer.enabled:
            tracer.counter("health.anomaly_rate", verdict["anomaly_rate"])
            tracer.counter("health.flagged_total",
                           verdict["flagged_total"])
            tracer.counter("health.drift_score", verdict["drift_score"])
            tracer.counter("health.round_time_s", round_time_s)
            for fl in verdict["new_flags"]:
                tracer.counter("health.flag", fl["score"], **fl)
        return verdict

    def _observe(self, round_idx, client_ids, stats, round_time_s):
        cfg = self.config
        ids = [int(c) for c in client_ids]
        n = len(ids)

        def col(name, default=0.0):
            seq = stats.get(name)
            if seq is None:
                return [default] * n
            return [float(v) for v in list(seq)[:n]]

        weight = col("weight", 1.0)
        rows = [i for i in range(n) if weight[i] > 0.0]
        norm = col("update_norm")
        cos = col("cosine")
        loss_d = col("loss_delta")
        stale = col("staleness")
        log_norm = [math.log(max(norm[i], 1e-12)) for i in range(n)]

        z_norm = _scatter_z(log_norm, rows, cfg.norm_floor)
        z_cos = _scatter_z(cos, rows, cfg.cosine_floor)
        z_loss = _scatter_z(loss_d, rows, cfg.loss_floor)
        # direction evidence gate: once training converges a BENIGN
        # client's update is near-zero noise and its cosine to the cohort
        # mean is arbitrary — only a client pushing with at least
        # median force can testify about direction (a label-flip keeps
        # pushing hard away; noise does not)
        med_norm = _median([norm[i] for i in rows] or [0.0])
        norm_gate = [min(norm[i] / max(med_norm, 1e-12), 1.0)
                     for i in range(n)]

        new_flags: List[Dict[str, Any]] = []
        flagged_in_cohort = 0
        with self._lock:
            for i in rows:
                cid = ids[i]
                # directional evidence: big norm / opposed direction /
                # elevated loss (label-flip reads as the latter two, a
                # scaled update as the first)
                score, reason = max(
                    (z_norm[i], "scaled_update"),
                    (-z_cos[i] * norm_gate[i], "direction"),
                    (z_loss[i], "loss"))
                score = max(score, 0.0)
                b = self._clients.setdefault(cid, _ClientBaseline())
                a = cfg.ewm_alpha
                b.evidence = ((1.0 - a) * b.evidence
                              + a * min(score / cfg.z_flag, 4.0))
                b.score_last = score
                b.obs += 1
                b.rounds.append(int(round_idx))
                del b.rounds[:-8]
                # bias-corrected EWM (ewm / (1 - (1-a)^n)): without it a
                # client whose every observation sits AT the flag line
                # needs ~1/a observations before the zero-initialized EWM
                # catches up — exactly the slow-flag regime the by-round-10
                # recall bar exists to prevent
                corrected = b.evidence / (1.0 - (1.0 - a) ** b.obs)
                was = cid in self._flagged
                flag_now = (score >= cfg.hard_z
                            or (b.obs >= cfg.min_obs
                                and corrected >= 1.0))
                if flag_now:
                    info = {"client": cid, "round": int(round_idx),
                            "score": round(score, 3), "reason": reason,
                            "staleness": stale[i]}
                    self._flagged[cid] = info
                    if not was:
                        new_flags.append(info)
                        self._flag_events.append(info)
                        del self._flag_events[:-cfg.recent]
                elif was and corrected < cfg.clear_score:
                    del self._flagged[cid]
                if cid in self._flagged:
                    flagged_in_cohort += 1

            drift = self._update_drift(
                {"cosine": _median([cos[i] for i in rows] or [0.0]),
                 "log_norm": _median([log_norm[i] for i in rows] or [0.0]),
                 "loss_delta": _median([loss_d[i] for i in rows] or [0.0])})
            self.rounds_observed += 1
            anomaly_rate = flagged_in_cohort / max(len(rows), 1)
            stale_real = sorted(stale[i] for i in rows)
            verdict = {
                "round": int(round_idx),
                "clients": len(rows),
                "anomaly_rate": round(anomaly_rate, 6),
                "flagged_in_cohort": flagged_in_cohort,
                "flagged_total": len(self._flagged),
                "drift_score": round(drift, 6),
                "drifting": drift >= cfg.drift_flag,
                "new_flags": new_flags,
                "staleness_p99": (stale_real[
                    min(len(stale_real) - 1,
                        int(0.99 * len(stale_real)))]
                    if stale_real else 0.0),
            }
            self._gauges = {
                "health.anomaly_rate": verdict["anomaly_rate"],
                "health.flagged_total": float(len(self._flagged)),
                "health.drift_score": verdict["drift_score"],
                "health.rounds_observed": float(self.rounds_observed),
                "health.round_time_s": float(round_time_s),
                "health.staleness_p99": float(verdict["staleness_p99"]),
            }
        return verdict

    def _update_drift(self, medians: Dict[str, float]) -> float:
        """Cohort drift: every round median keeps an EWM baseline; the
        drift score is the worst |median − baseline| in floor units.
        Warmup rounds only seed the baseline."""
        cfg = self.config
        floors = {"cosine": cfg.cosine_floor, "log_norm": cfg.norm_floor,
                  "loss_delta": cfg.loss_floor}
        score = 0.0
        for k, v in medians.items():
            if k not in self._drift_base:
                self._drift_base[k] = v
                continue
            base = self._drift_base[k]
            if self._drift_rounds >= cfg.drift_warmup:
                score = max(score, abs(v - base) / floors[k])
            self._drift_base[k] = ((1.0 - cfg.drift_alpha) * base
                                   + cfg.drift_alpha * v)
        self._drift_rounds += 1
        self._drift_score = score
        return score

    # -- read side ----------------------------------------------------------
    def flagged(self) -> List[int]:
        with self._lock:
            return sorted(self._flagged)

    def flag_details(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(self._flagged[c]) for c in sorted(self._flagged)]

    def recent_flags(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(f) for f in self._flag_events]

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def verdict(self, extra_metrics: Optional[Dict[str, float]] = None
                ) -> Dict[str, Any]:
        """The /healthz body: SLO evaluation over fedmon gauges merged
        with any caller-provided metric set (tracer counters)."""
        metrics = dict(extra_metrics or {})
        metrics.update(self.gauges())
        return evaluate_slos(self.slo_rules, metrics)


# --------------------------------------------------------------------------
# SLO rules — declarative ok / degraded / unhealthy
# --------------------------------------------------------------------------

#: rules evaluated when no ``health_slo_path`` YAML is given; rules whose
#: metric is absent from the gauge set are skipped (a train-only run is
#: not "degraded" for lacking serving gauges)
DEFAULT_SLO_RULES: List[Dict[str, Any]] = [
    # fedguard reliability plane (docs/FAULT_TOLERANCE.md): a sustained
    # retry storm degrades; any rank missing from the round degrades
    # ("quorum below S"); a round that could not seat its quorum Q is
    # unhealthy; lease-dead ranks degrade until they heal or are
    # replaced
    {"name": "comm_retry_rate", "metric": "comm.retry_rate",
     "max": 0.25, "crit": 0.75},
    {"name": "quorum_full", "metric": "comm.quorum_missing_ranks",
     "max": 0.0},
    {"name": "quorum_met", "metric": "comm.quorum_deficit",
     "crit": 0.0},
    {"name": "dead_ranks", "metric": "comm.dead_ranks", "max": 0.0},
    {"name": "round_time", "metric": "health.round_time_s",
     "max": 60.0, "crit": 600.0},
    {"name": "anomaly_rate", "metric": "health.anomaly_rate",
     "max": 0.3, "crit": 0.6},
    {"name": "drift", "metric": "health.drift_score", "max": 8.0},
    {"name": "staleness_p99", "metric": "async.staleness_p99",
     "max": 10.0},
    {"name": "serve_queue_depth", "metric": "serve.queue_depth",
     "max": 16.0, "crit": 128.0},
    {"name": "serve_p99", "metric": "serve.latency_p99_ms",
     "max": 250.0},
    # fedslo objective rule (docs/OBSERVABILITY.md): "p99 TTFT < 200 ms
    # over 99% of requests", evaluated as multi-window burn-rate alerts
    # when the caller wires an ObjectiveWindow stream (obs/slo.py);
    # skipped, like any absent metric, on processes without one
    {"name": "serve_ttft_p99",
     "objective": {"metric": "serve_ttft_seconds", "threshold": 0.2,
                   "compliance": 0.99}},
    # paged serving memory plane (docs/SERVING.md): a drained page pool
    # means admissions are parking — degraded before it becomes queue
    # growth; an adapter-miss storm (most acquires paging in from the
    # store) means the HBM cache is thrashing — resize
    # adapter_cache_slots or shard the adapter population
    {"name": "kv_page_pool", "metric": "serve.kv_pages_free",
     "min": 1.0},
    {"name": "adapter_miss_storm", "metric": "serve.adapter_miss_rate",
     "max": 0.5},
]


def load_slo_rules(path: str) -> List[Dict[str, Any]]:
    """SLO rules from YAML (``{"slos": [...]}`` or a bare list).  Two
    rule shapes: point rules — ``name``, ``metric`` (a tracer-counter /
    fedmon gauge name), ``max`` and/or ``min`` warn bounds with optional
    ``crit`` / ``crit_min`` critical bounds — and fedslo objective rules
    — ``name`` plus an ``objective`` mapping (``metric``, ``threshold``,
    ``compliance``) evaluated as multi-window burn-rate alerts
    (:mod:`fedml_tpu_torch.obs.slo`)."""
    import yaml
    with open(path) as fh:
        data = yaml.safe_load(fh) or {}
    rules = data.get("slos", data) if isinstance(data, dict) else data
    if not isinstance(rules, list):
        raise ValueError(f"{path}: expected a list or {{'slos': [...]}}")
    for r in rules:
        if "objective" in r:
            from .slo import validate_objective
            validate_objective(r["objective"],
                               where=f"{path}: {r.get('name', r)!r}")
        elif "metric" not in r:
            raise ValueError(f"{path}: SLO rule missing 'metric': {r!r}")
    return rules


def evaluate_slos(rules: Iterable[Dict[str, Any]],
                  metrics: Dict[str, float],
                  objectives: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """ok / degraded / unhealthy over the rule set.

    A point rule breaches *warn* when the metric exceeds ``max`` (or
    falls below ``min``), *crit* at ``crit`` / ``crit_min``.  Any crit
    breach ⇒ unhealthy; any warn breach ⇒ degraded; rules whose metric
    is absent are reported as skipped and do not affect the verdict.

    Objective rules (``rule["objective"]``) evaluate as multi-window
    burn-rate alerts against the matching
    :class:`~fedml_tpu_torch.obs.slo.ObjectiveWindow` in ``objectives``
    (keyed by rule name or objective metric); with no stream wired they
    are skipped, same as an absent point metric."""
    checks: List[Dict[str, Any]] = []
    status = "ok"
    order = ("ok", "degraded", "unhealthy")
    rules = list(rules)
    # evaluate objective rules up front, then emit every row in the
    # caller's DECLARED rule order (checks[i] stays rule i)
    objective_rules = [r for r in rules if r.get("objective")]
    obj_rows: Dict[int, Dict[str, Any]] = {}
    if objective_rules:
        from .slo import evaluate_objective_rules
        obj_rows = {
            id(r): row for r, row in zip(
                objective_rules,
                evaluate_objective_rules(objective_rules,
                                         objectives or {}))}
    for rule in rules:
        if rule.get("objective"):
            row = obj_rows[id(rule)]
            checks.append(row)
            lvl = row.get("status", "skipped")
            if lvl in order and order.index(lvl) > order.index(status):
                status = lvl
            continue
        metric = rule["metric"]
        v = metrics.get(metric)
        row: Dict[str, Any] = {"name": rule.get("name", metric),
                               "metric": metric}
        if v is None:
            row["status"] = "skipped"
            checks.append(row)
            continue
        v = float(v)
        row["value"] = round(v, 6)
        level = "ok"
        if "crit" in rule and v > float(rule["crit"]):
            level = "unhealthy"
        elif "crit_min" in rule and v < float(rule["crit_min"]):
            level = "unhealthy"
        elif "max" in rule and v > float(rule["max"]):
            level = "degraded"
        elif "min" in rule and v < float(rule["min"]):
            level = "degraded"
        row["status"] = level
        for b in ("max", "min", "crit", "crit_min"):
            if b in rule:
                row[b] = float(rule[b])
        checks.append(row)
        order = ("ok", "degraded", "unhealthy")
        if order.index(level) > order.index(status):
            status = level
    return {"status": status, "checks": checks}


def _scatter_z(vals: List[float], rows: List[int], floor: float
               ) -> List[float]:
    """Robust z over the REAL rows only, scattered back to full cohort
    length (pad rows read 0)."""
    out = [0.0] * len(vals)
    if not rows:
        return out
    zs = robust_z([vals[i] for i in rows], floor)
    for i, z in zip(rows, zs):
        out[i] = z
    return out
