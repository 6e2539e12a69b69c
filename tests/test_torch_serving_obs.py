"""Serving's observability hooks in the port against the JAX package's, on
the CPU, from the same weights and numpy-seeded prompts (``TINY`` widths,
f32, LoRA rank 4):

- the batching engine with ``metrics_port=0``, ``slo_rules`` (a TTFT
  objective and an error-rate point rule) and ``hist_labels=2``, tracing
  on, 8 requests over two adapters, then a trailing request after a pause
  that rolls the token window: the tokens equal the JAX engine's and the
  port's own run with every hook off; the host counters
  (``serve_stats``), the histogram counts by label, the request counters
  (``serve.requests_by_adapter`` and the legacy ``serve.requests.<name>``)
  and the last ``serve.tokens_total`` equal the JAX engine's; the span
  tree (``serve.request``/``queue``/``decode``, ``serve.admit``,
  ``serve.prefill``) has the JAX engine's spans and carries the
  ``traceparent``'s trace id; ``/metrics`` parses; ``stop()`` closes it;
- the OpenAI-compatible server with ``metrics_port`` and ``slo_rules``
  (the port's alone, on the JAX server's code paths): a ``traceparent``
  header reaches the engine's span, a malformed one is dropped, a stream
  has its ``serve.stream`` span and a sampled request with ``top_k`` its
  fall-through ``serve.request``; ``/metrics`` answers with the engine's
  histograms.
"""

import collections
import dataclasses
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedml_tpu import obs as j_obs
from fedml_tpu.llm import model as jm
from fedml_tpu.serving.batching import ContinuousBatchingEngine as JEngine
from fedml_tpu_torch import obs as t_obs
from fedml_tpu_torch.llm import model as tm
from fedml_tpu_torch.llm.convert import from_flax, lora_from_flax
from fedml_tpu_torch.obs.metricsd import parse_prometheus_text, prom_value
from fedml_tpu_torch.serving.batching import ContinuousBatchingEngine
from fedml_tpu_torch.serving.templates.openai_compat import \
    OpenAICompatServer

BUF = 40
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
TRACEPARENT = f"00-{TRACE_ID}-00f067aa0ba902b7-01"
RULES = [{"name": "ttft", "objective": {"metric": "serve_ttft_seconds",
                                        "threshold": 30.0,
                                        "compliance": 0.99}},
         {"name": "error_rate", "metric": "serve.error_rate", "max": 0.01}]
ADAPTERS = ["a0", "a1"] * 4
BUDGETS = [6, 4, 7, 3, 5, 6, 4, 5]
SPANS = ("serve.request", "serve.queue", "serve.decode", "serve.admit",
         "serve.prefill")


@pytest.fixture(scope="module")
def lm():
    over = dict(max_seq_len=48, attn_impl="blockwise", lora_rank=4,
                vocab_size=258)
    jmodel = jm.LlamaLM(dataclasses.replace(jm.TINY, **over))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8), jnp.int32))
    params_np = jax.tree_util.tree_map(np.asarray, variables["params"])
    tmodel, _ = from_flax(params_np, None,
                          dataclasses.replace(tm.TINY, **over), device="cpu")
    rng = np.random.default_rng(5)
    loras = {}
    for i, name in enumerate(("a0", "a1")):
        flat, treedef = jax.tree_util.tree_flatten(variables["lora"])
        loras[name] = jax.tree_util.tree_unflatten(treedef, [
            (0.5 * rng.standard_normal(leaf.shape)).astype(np.float32)
            for leaf in flat])
    prompts = [list(map(int, rng.integers(0, 256, n)))
               for n in (3, 20, 9, 14, 5, 17, 12, 8)]
    return dict(jmodel=jmodel, params=variables["params"], tmodel=tmodel,
                jloras=loras,
                tloras={k: lora_from_flax(v, "cpu")
                        for k, v in loras.items()},
                prompts=prompts)


def _drain(q):
    return [t for t in iter(lambda: q.get(timeout=120), None)]


def _serve(eng, prompts):
    """The 8 requests at once (the first with the traceparent), then a
    trailing 2-token request after a pause, so the loop's token window
    rolls after every other token."""
    qs = [eng.submit(p, max_new_tokens=b, adapter=a,
                     traceparent=TRACEPARENT if i == 0 else None)
          for i, (p, b, a) in enumerate(zip(prompts, BUDGETS, ADAPTERS))]
    toks = [_drain(q) for q in qs]
    time.sleep(0.6)
    toks.append(_drain(eng.submit(prompts[0][:2], max_new_tokens=2,
                                  adapter="a1")))
    return toks


def _get_json(url):
    """GET a JSON endpoint; /healthz answers 503 with its body when not
    healthy."""
    try:
        return json.loads(urllib.request.urlopen(url, timeout=30).read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def _traced(pkg_obs, make, prompts):
    """Run ``make()``'s engine with the package's tracer on; its tokens,
    host counters, counter samples, span counts and /metrics text."""
    tr = pkg_obs.configure(enabled=True, reset=True)
    try:
        eng = make()
        try:
            toks = _serve(eng, prompts)
            url = eng.metrics_server.url
            text = urllib.request.urlopen(url + "/metrics",
                                          timeout=30).read().decode()
            health = _get_json(url + "/healthz")
        finally:
            eng.stop()
        assert eng.metrics_server is None
        events = tr.events()
    finally:
        pkg_obs.configure(enabled=False, reset=True)
    counters = collections.defaultdict(list)
    spans = collections.Counter()
    request_args = []
    for ev in events:
        if ev.get("ph") == "C":
            counters[ev["name"]].append(
                (ev["args"]["value"], ev["args"].get("adapter")))
        elif ev.get("ph") == "B":
            spans[ev["name"]] += 1
            if ev["name"] == "serve.request":
                request_args.append(ev["args"])
    hists = {h.name: {k: v["count"] for k, v in h.snapshot().items()}
             for h in eng.serve_hists.histograms()}
    return dict(toks=toks, stats=eng.serve_stats, counters=counters,
                spans=spans, request_args=request_args, metrics=text,
                health=health, hists=hists,
                labels=eng.serve_hists.labels.counts())


@pytest.fixture(scope="module")
def runs(lm):
    """Both engines with every hook on (the legacy per-adapter counters
    too), and the port's engine with every hook off."""
    import os
    os.environ["FEDML_SERVE_LEGACY_ADAPTER_COUNTERS"] = "1"
    try:
        def jmake():
            eng = JEngine(lm["jmodel"], lm["params"], slots=4, buf_len=BUF,
                          adapter_slots=3, metrics_port=0, slo_rules=RULES,
                          hist_labels=2)
            for k, v in lm["jloras"].items():
                eng.registry.register(k, v)
            return eng

        def tmake():
            eng = ContinuousBatchingEngine(
                lm["tmodel"], None, slots=4, buf_len=BUF, adapter_slots=3,
                metrics_port=0, slo_rules=RULES, hist_labels=2)
            for k, v in lm["tloras"].items():
                eng.registry.register(k, v)
            return eng

        out = {"jax": _traced(j_obs, jmake, lm["prompts"]),
               "port": _traced(t_obs, tmake, lm["prompts"])}
    finally:
        del os.environ["FEDML_SERVE_LEGACY_ADAPTER_COUNTERS"]
    off = ContinuousBatchingEngine(lm["tmodel"], None, slots=4, buf_len=BUF,
                                   adapter_slots=3)
    try:
        for k, v in lm["tloras"].items():
            off.registry.register(k, v)
        out["off"] = _serve(off, lm["prompts"])
        assert off.metrics_server is None and not off.slo_windows
    finally:
        off.stop()
    return out


def test_tokens_match_jax_and_the_hooks_off_run(runs):
    assert runs["port"]["toks"] == runs["jax"]["toks"] == runs["off"]
    assert [len(t) for t in runs["port"]["toks"]] == BUDGETS + [2]


def test_host_counters_and_histograms_match_jax(runs):
    p, j = runs["port"], runs["jax"]
    assert p["stats"] == j["stats"]
    assert p["stats"]["tokens"] == sum(BUDGETS) + 2
    assert p["stats"]["requests"] == {"a0": 4, "a1": 5}
    assert p["labels"] == j["labels"]
    assert p["hists"] == j["hists"]
    assert p["hists"]["serve_ttft_seconds"] == {"a0": 4, "a1": 5}


def test_counter_samples_match_jax(runs):
    p, j = runs["port"]["counters"], runs["jax"]["counters"]
    for name in ("serve.requests_by_adapter", "serve.requests.a0",
                 "serve.requests.a1"):
        assert p[name] == j[name], name
    assert [v for v, _ in p["serve.requests.a1"]] == [1, 2, 3, 4, 5]
    # the trailing request rolls the window after every other token
    assert p["serve.tokens_total"][-1][0] == j["serve.tokens_total"][-1][0] \
        == runs["port"]["stats"]["tokens"]
    assert set(p) == set(j)


def test_span_tree_matches_jax_and_carries_the_trace_id(runs):
    p, j = runs["port"], runs["jax"]
    assert {k: p["spans"][k] for k in SPANS} == \
        {k: j["spans"][k] for k in SPANS} == {k: 9 for k in SPANS}
    tagged = [a for a in p["request_args"] if a.get("traceparent")]
    assert len(tagged) == 1 and TRACE_ID in tagged[0]["traceparent"]
    keys = lambda args: sorted(set(k for a in args for k in a)
                               - {"span_id"})
    assert keys(p["request_args"]) == keys(j["request_args"])


def test_metrics_endpoint_parses_like_jax(runs):
    p = parse_prometheus_text(runs["port"]["metrics"])
    j = parse_prometheus_text(runs["jax"]["metrics"])
    names = lambda samples: sorted({s[0] for s in samples})
    assert names(p) == names(j)
    assert prom_value(p, "serve_e2e_seconds_count", adapter="a1") == \
        prom_value(j, "serve_e2e_seconds_count", adapter="a1") == 5.0
    assert runs["port"]["health"]["status"] == \
        runs["jax"]["health"]["status"]
    assert [c.get("status") for c in runs["port"]["health"]["checks"]] == \
        [c.get("status") for c in runs["jax"]["health"]["checks"]]


def _post(port, path, payload, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read().decode()


def test_server_hooks_and_endpoint(lm):
    """The server's own /metrics (its engine's histograms appended), the
    traceparent header into the engine's span, a malformed one dropped,
    the stream's span and the fall-through request's span."""
    tr = t_obs.configure(enabled=True, reset=True)
    srv = OpenAICompatServer(None, None, model=lm["tmodel"], batch_slots=2,
                             buf_len=BUF, metrics_port=0, slo_rules=RULES)
    try:
        port = srv.start()
        assert srv._engine.slo_windows and srv.metrics_server is not None
        _post(port, "/v1/completions", {"prompt": "hi", "max_tokens": 3},
              {"traceparent": TRACEPARENT})
        _post(port, "/v1/completions", {"prompt": "yo", "max_tokens": 2},
              {"traceparent": "not-a-traceparent"})
        _post(port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "x"}], "stream": True,
            "max_tokens": 2})
        _post(port, "/v1/completions", {"prompt": "z", "max_tokens": 2,
                                        "temperature": 0.7, "top_k": 5})
        text = urllib.request.urlopen(srv.metrics_server.url + "/metrics",
                                      timeout=30).read().decode()
    finally:
        srv.stop()
        events = tr.events()
        t_obs.configure(enabled=False, reset=True)
    assert srv.metrics_server is None
    begins = [e for e in events if e.get("ph") == "B"]
    reqs = [e["args"] for e in begins if e["name"] == "serve.request"]
    assert len(reqs) == 4
    assert [a.get("traceparent") for a in reqs].count(TRACEPARENT) == 1
    assert sum(a.get("traceparent") is not None for a in reqs) == 1
    assert [a.get("path") for a in reqs].count("fallthrough") == 1
    assert sum(e["name"] == "serve.stream" for e in begins) == 1
    samples = parse_prometheus_text(text)
    assert prom_value(samples, "serve_e2e_seconds_count",
                      adapter="base") == 3.0
