"""The port's stdlib obs modules against the JAX package's, on the CPU.

``fedml_tpu_torch/obs/{histogram,slo,canary,health,metricsd}.py`` are
copies of the JAX package's modules, and the port's tracer carries the
JAX tracer's ``complete``, ``round_obs``, ``export_prometheus``,
``sanitize_metric_name`` and ``escape_label_value``.  Each scenario below
runs the same inputs through both packages' modules and compares the
outputs exactly: Prometheus text byte for byte, quantiles, burn rates,
canary verdicts and health flags as equal values.  Every value here is a
host float computed by the same code, so the bar is equality, with no
tolerance.  The live endpoint runs on loopback (port 0)."""

import importlib
import json
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

MODULES = ("tracer", "histogram", "slo", "canary", "health", "metricsd")


def _pkg(root):
    ns = type("obs", (), {})()
    for m in MODULES:
        setattr(ns, m, importlib.import_module(f"{root}.obs.{m}"))
    return ns


J = _pkg("fedml_tpu")
T = _pkg("fedml_tpu_torch")

OBJ = {"metric": "serve_ttft_seconds", "threshold": 0.2,
       "compliance": 0.99}


def _stats(rng, n, flipped=()):
    """Per-client stat lanes: benign heterogeneity, a label-flip signature
    (cosine far below the cohort, loss up) on ``flipped``."""
    norm = rng.lognormal(0.0, 0.15, n)
    cos = rng.normal(0.6, 0.05, n)
    loss = rng.normal(0.0, 0.05, n)
    for i in flipped:
        cos[i], loss[i] = -0.5, 1.5
    return {"update_norm": norm.tolist(), "cosine": cos.tolist(),
            "loss_delta": loss.tolist(), "weight": [1.0] * n}


# -- scenarios: each runs on one package's modules ---------------------------

def _tracer(m):
    tr = m.tracer.Tracer()
    tr.enabled = True
    return tr


def histogram_scenario(m, tmp):
    rng = np.random.default_rng(7)
    samples = rng.lognormal(-3.0, 0.8, 300).tolist()
    h = m.histogram.Histogram("serve_ttft_seconds", max_labels=2)
    for i, v in enumerate(samples):
        h.record(v, ["a", 'we"ird\\lab\nel', "c", None][i % 4])
    h.record(1e6)
    text = h.render_prometheus()
    snap = h.snapshot()
    parsed = m.histogram.buckets_from_samples(
        m.metricsd.parse_prometheus_text(text), "serve_ttft_seconds")
    merged = m.histogram.merge_bucket_entries(list(snap.values()))
    labels = m.histogram.BoundedLabels(k=2)
    resolved = [labels.resolve(x) for x in "abcadb"]
    return {"text": text, "snap": snap, "parsed": parsed,
            "merged": merged,
            "q": [m.histogram.quantile_from_buckets(merged, q)
                  for q in (0.5, 0.9, 0.99, 1.0)],
            "diff": m.histogram.diff_bucket_entries(merged, snap["a"]),
            "labels": (resolved, labels.counts(), labels.top(2)),
            "bounds": m.histogram.log_boundaries(0.001, 60.0, 5)}


def slo_scenario(m, tmp):
    now = [100_000.0]
    win = m.slo.ObjectiveWindow(OBJ, clock=lambda: now[0])
    for _ in range(50):
        win.observe(1.0, t=now[0] - 2000.0)
    for i in range(60):
        win.observe(0.3 if i % 7 == 0 else 0.01, t=now[0] - 10.0)
    rules = [{"name": "ttft", "objective": OBJ},
             {"name": "none", "objective": dict(OBJ, metric="x")}]
    wins = m.slo.windows_for_rules(rules)
    wins["ttft"].observe(0.5, t=0.0)
    return {"eval": win.evaluate(),
            "burn": [win.burn_rate(w) for w in (300.0, 3600.0, 21600.0)],
            "rules": m.slo.evaluate_objective_rules(
                rules, objectives={"ttft": win}),
            "budget": m.slo.objective_budget({"compliance": 0.999}),
            "windows": sorted(wins)}


def canary_scenario(m, tmp):
    audit = str(tmp / f"{m.canary.__name__}.jsonl")
    judge = m.canary.CanaryJudge([{"name": "ttft", "objective": OBJ}],
                                 audit_path=audit, clock=lambda: 1234.5)
    rng = np.random.default_rng(11)

    def stream(mu, sigma, n):
        h = m.histogram.Histogram("serve_ttft_seconds")
        for v in rng.lognormal(mu, sigma, n):
            h.record(float(v))
        return h

    base = stream(-3.5, 0.4, 200)
    out = [judge.judge(base, stream(-3.5, 0.4, 200), adapter="good"),
           judge.judge(base, stream(-0.5, 0.3, 200), adapter="bad"),
           judge.judge(base, stream(-3.5, 0.4, 5), adapter="thin")]
    a = stream(-3.0, 0.5, 300).snapshot()["base"]
    c = stream(-1.0, 0.5, 300).snapshot()["base"]
    return {"verdicts": out, "audit": m.canary.validate_audit_log(audit),
            "chi2": m.canary.chi2_two_sample(a, c)}


def health_scenario(m, tmp):
    rng = np.random.default_rng(3)
    flipped = (2, 5)
    mon = m.health.HealthMonitor(
        m.health.HealthConfig(z_flag=5.0, ewm_alpha=0.6, min_obs=2),
        slo_rules=[{"name": "rt", "metric": "health.round_time_s",
                    "max": 0.5, "crit": 2.0},
                   *m.health.DEFAULT_SLO_RULES])
    verdicts = []
    for r in range(6):
        ids = list(range(16))
        stats = _stats(rng, 16, flipped)
        stats["staleness"] = [float(r % 3)] * 16
        if r == 4:      # a pad row (weight 0) past the ids, as a mesh sends
            for f in stats:
                stats[f] = stats[f] + [0.0]
        verdicts.append(mon.observe_round(r, ids, stats,
                                          round_time_s=0.1 * (r + 1)))
    p = tmp / f"{m.health.__name__}.yaml"
    p.write_text("slos:\n  - {name: rt, metric: health.round_time_s, "
                 "max: 0.3, crit: 1.0}\n")
    g = mon.gauges()
    return {"verdicts": verdicts, "flagged": mon.flagged(),
            "details": mon.flag_details(), "recent": mon.recent_flags(),
            "gauges": g,
            "slos": m.health.evaluate_slos(mon.slo_rules, g),
            "yaml": m.health.load_slo_rules(str(p)),
            "z": m.health.robust_z([1.0, 1.1, 0.9, 5.0, 1.05], 0.1)}


def metricsd_scenario(m, tmp):
    mon = m.health.HealthMonitor()
    mon.observe_round(0, list(range(8)), _stats(np.random.default_rng(0), 8),
                      round_time_s=0.25)
    tr = _tracer(m)
    tr.counter('serve.requests.adapter-"x\\y"', 7)
    tr.complete("cuda_graph_capture", 0.125, cat="compile")
    srv = m.metricsd.MetricsServer(tracer=tr, monitor=mon)
    text = srv.metrics_text()
    samples = m.metricsd.parse_prometheus_text(text)
    bad = []
    for line in ('bad{name="unterminated} 1\n', "no value here\n"):
        try:
            m.metricsd.parse_prometheus_text(line)
        except ValueError:
            bad.append(line)
    return {"text": text, "samples": samples,
            "value": m.metricsd.prom_value(samples, "fedmon_gauge",
                                           name="health.rounds_observed"),
            "healthz": srv.healthz(), "debug": srv.debug_health(),
            "render": m.metricsd.render_gauges({"a.b": 1.5, 'q"': 2}),
            "bad": bad}


def tracer_scenario(m, tmp):
    tr = _tracer(m)
    tr.complete('serve.admit "cohort-1"', 0.25, cat="serve", end_s_ago=1.0)
    tr.complete("xla_compile", 1.5, cat="compile", fn=None)
    tr.counter("async.staleness_p99", 3.5)
    tr.add_bytes("device_put_bytes", 4096)
    tr.add_bytes("device_put_bytes", 1024)
    tr.round_obs(3, 0.5, {"steps": 30.0, "update_norm": 0.8})
    rows = [e["args"] for e in tr.events() if e.get("name") == "obs.round"]
    names = ["serve.tokens/s", "9lives", "", "ok_name:x", "a-b.c"]
    return {"prom": tr.export_prometheus(), "rows": rows,
            "summary": tr.summary(),
            "names": [m.tracer.sanitize_metric_name(n) for n in names],
            "labels": [m.tracer.escape_label_value(v)
                       for v in ('a"b', "c\\d", "e\nf", 7)],
            "phases": (m.tracer.DEVICE_PHASES, m.tracer.PHASES)}


SCENARIOS = [histogram_scenario, slo_scenario, canary_scenario,
             health_scenario, metricsd_scenario, tracer_scenario]


def _json(x):
    return json.loads(json.dumps(x, sort_keys=True, default=repr))


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_copy_matches_the_jax_module(scenario, tmp_path):
    """The port's copy gives the JAX module's outputs on the same inputs,
    exactly (text byte for byte)."""
    from fedml_tpu import obs as j_obs
    from fedml_tpu_torch import obs as t_obs
    try:
        want = scenario(J, tmp_path)
        got = scenario(T, tmp_path)
    finally:
        for o in (j_obs, t_obs):
            o.configure(enabled=False)
            o.get_tracer().reset()
    for key in want:
        if isinstance(want[key], str):
            assert got[key] == want[key], key
        else:
            assert _json(got[key]) == _json(want[key]), key


def test_health_flags_the_planted_clients():
    """The health scenario is not vacuous: the monitor flags the two
    planted label-flip clients and no other."""
    import pathlib
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        out = health_scenario(T, pathlib.Path(d))
    assert sorted(out["flagged"]) == [2, 5]
    assert out["gauges"]["health.rounds_observed"] == 6.0


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def test_metrics_endpoint_serves_and_healthz_goes_503():
    """The port's endpoint on loopback (port 0): /metrics parses, /healthz
    is ok before any round, 503 once an SLO's crit bound is crossed, and
    /debug/health lists the flags."""
    from fedml_tpu_torch.obs import health, metricsd
    mon = health.HealthMonitor(slo_rules=[
        {"metric": "health.round_time_s", "max": 1e-9, "crit": 1e-6}])
    srv = metricsd.MetricsServer(monitor=mon)
    port = srv.start()
    try:
        assert port > 0 and srv.host == "127.0.0.1"
        code, body = _get(srv.url + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        mon.observe_round(0, [0, 1], _stats(np.random.default_rng(0), 2),
                          round_time_s=1.0)
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/healthz")
        assert e.value.code == 503
        assert json.loads(e.value.read().decode())["status"] == "unhealthy"
        code, body = _get(srv.url + "/metrics")
        samples = metricsd.parse_prometheus_text(body)
        assert metricsd.prom_value(samples, "fedmon_gauge",
                                   name="health.rounds_observed") == 1.0
        code, body = _get(srv.url + "/debug/health")
        assert code == 200 and "flagged" in json.loads(body)
    finally:
        srv.close()


def test_obs_modules_import_with_jax_unimportable():
    """The obs plane, the runtime audit and the engines that wire them
    import where ``jax`` and ``fedml_tpu`` cannot be imported at all;
    ``configure(jax_hooks=True)`` still raises by name."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'fedml_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from fedml_tpu_torch import obs\n"
        "from fedml_tpu_torch.obs import (canary, carry, devicetime,\n"
        "    health, histogram, metricsd, slo, torchhooks)\n"
        "from fedml_tpu_torch.analysis import TorchRuntimeAudit\n"
        "from fedml_tpu_torch.simulation.sp import fedavg_api\n"
        "from fedml_tpu_torch.simulation import async_engine\n"
        "from fedml_tpu_torch.simulation.mesh import engine\n"
        "assert obs.Histogram and obs.MetricsServer and obs.round_obs\n"
        "try:\n"
        "    obs.configure(enabled=True, jax_hooks=True)\n"
        "except NotImplementedError as e:\n"
        "    assert 'jax_hooks' in str(e)\n"
        "else:\n"
        "    raise SystemExit('jax_hooks did not raise')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
