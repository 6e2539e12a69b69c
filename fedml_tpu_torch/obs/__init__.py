"""fedtrace, the sync-free round-telemetry plane (port of
``fedml_tpu.obs``).

Three layers, one overhead contract (no extra host sync, transfer, round
build or graph capture on the round path; pinned with
``analysis.runtime.TorchRuntimeAudit`` by ``tests/test_torch_obs_*.py``
and on the card by ``chip_smoke.py``'s obs phase):

1. **Device-carry metrics** (:mod:`.carry`): the per-round ObsCarry row
   (per-phase FLOP weights, cohort counters, update norm, modeled
   collective bytes) computed on the round's device, returned through
   the metrics dict the loss rides (stacked ``(K,)`` by a fused block's
   graph) and read at the round loop's existing sync.
2. **Host spans + counters** (:mod:`.tracer`): staging, eval, round and
   block spans, store paging, FedBuff dispatch/arrival, CUDA-graph
   captures and explicit transfer bytes (:mod:`.torchhooks`), exported as
   Chrome trace JSON plus a Prometheus text dump; the out-of-band
   ``trace_device`` probe (:mod:`.devicetime`) times the four device
   phases with CUDA events.
3. **Analysis**: ``tools/fedtrace.py summarize`` reads the port's traces.

fedmon extends the plane with federation health: :mod:`.health` (robust
per-client anomaly and drift detection and declarative SLO rules over the
per-client lanes the engines compute on the device) and :mod:`.metricsd`
(the threaded ``/metrics`` · ``/healthz`` · ``/debug/health`` endpoint
behind ``args.metrics_port``); fedslo's :mod:`.histogram`, :mod:`.slo`
and :mod:`.canary` are stdlib copies of the JAX modules.  The fedscope
trace-context propagation is :mod:`.context`.
"""

from __future__ import annotations

from . import context  # noqa: F401  (fedscope trace-context propagation)
from .health import (  # noqa: F401  (stdlib-only, like the tracer)
    DEFAULT_SLO_RULES,
    HealthConfig,
    HealthMonitor,
    evaluate_slos,
    load_slo_rules,
)
from .tracer import (  # noqa: F401
    DEVICE_PHASES,
    PHASES,
    Tracer,
    configure,
    escape_label_value,
    get_tracer,
    sanitize_metric_name,
    trace_enabled,
    tree_nbytes,
)

#: symbols resolved lazily so importing :mod:`fedml_tpu_torch.obs` (e.g.
#: from a comm manager) stays stdlib-light; :mod:`.carry` pulls in torch
_CARRY_EXPORTS = ("OBS_FIELDS", "ObsCarry", "OPT_FLOPS", "obs_host",
                  "obs_host_rows", "obs_population_rows", "param_count",
                  "round_obs")
#: :mod:`.metricsd` exports, lazy for the same reason (http.server)
_METRICSD_EXPORTS = ("MetricsServer", "parse_prometheus_text",
                     "prom_value", "start_from_args")
#: fedslo exports (:mod:`.histogram` / :mod:`.slo` / :mod:`.canary`)
_FEDSLO_EXPORTS = {
    "BoundedLabels": "histogram", "Histogram": "histogram",
    "ServeHistograms": "histogram",
    "buckets_from_samples": "histogram",
    "merge_bucket_entries": "histogram",
    "quantile_from_buckets": "histogram",
    "BURN_WINDOWS": "slo", "ObjectiveWindow": "slo",
    "evaluate_objective_rules": "slo", "windows_for_rules": "slo",
    "CanaryJudge": "canary", "validate_audit_log": "canary",
}
#: :mod:`.devicetime`
_DEVICETIME_EXPORTS = ("measure_device_phases",)

__all__ = ["DEVICE_PHASES", "PHASES", "DEFAULT_SLO_RULES", "HealthConfig",
           "HealthMonitor", "Tracer", "configure", "context",
           "escape_label_value", "evaluate_slos", "get_tracer",
           "load_slo_rules", "sanitize_metric_name", "trace_enabled",
           "tree_nbytes", *_CARRY_EXPORTS, *_METRICSD_EXPORTS,
           *_FEDSLO_EXPORTS, *_DEVICETIME_EXPORTS]


def __getattr__(name):
    import importlib
    if name in _CARRY_EXPORTS:
        mod = "carry"
    elif name in _METRICSD_EXPORTS:
        mod = "metricsd"
    elif name in _DEVICETIME_EXPORTS:
        mod = "devicetime"
    elif name in _FEDSLO_EXPORTS:
        mod = _FEDSLO_EXPORTS[name]
    else:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
