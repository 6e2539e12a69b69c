"""The obs plane on the port's engines against the JAX package's, on the
CPU: federation health on sp, fused, FedBuff and the mesh; the trace
``tools/fedtrace.py`` reads; the ``/metrics`` endpoint behind an engine.

- **Flagged clients.** ``tests/test_fedmon.py::_flipped_api``'s config
  (``lr``, 64 clients, 32 a round, 6 label-flipped, 10 rounds, seed 7):
  the port and the JAX package flag the same set, and it is the flipped
  set (precision and recall 1).  On FedBuff the buffer is the cohort
  (``async_buffer_k`` 32, latency median 5 s, 3 generations in flight);
  the JAX test's 16-client, 12-round FedBuff variant flags 5 of the 6 on
  both packages on this CPU (client 2 is seen too rarely to pass the
  detector's ``min_obs``).  The mesh engine (a world of 1 over gloo; the
  JAX mesh engine cannot run in this image, see
  ``tests/torch_mesh_parity.py``) is held to the JAX sp engine.
- **The mesh's rows.** The mesh engine's ObsCarry rows and health lanes
  match the JAX sp engine's within 1e-5 (relative, lane-normalised, as in
  ``tests/test_torch_obs_round.py``) but for the byte fields, which are
  the mesh's own byte model (``MeshFedAvgAPI.collective_bytes``).
- **Traced ≡ untraced** on FedBuff's buffered path and the mesh's fused
  blocks: bitwise losses and params, equal ``TorchRuntimeAudit`` counts.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu import data as j_data
from fedml_tpu import model as j_model
from fedml_tpu import obs as j_obs
from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.obs.carry import obs_host as j_obs_host
from fedml_tpu.obs.carry import obs_host_rows as j_obs_rows
from fedml_tpu.simulation.async_engine import FedBuffAPI as JFedBuffAPI
from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI

from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch import obs as t_obs
from fedml_tpu_torch.analysis import TorchRuntimeAudit
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.core import mesh as t_mesh
from fedml_tpu_torch.models.convert import from_flax
from fedml_tpu_torch.obs.carry import obs_host, obs_host_rows
from fedml_tpu_torch.obs.metricsd import parse_prometheus_text, prom_value
from fedml_tpu_torch.simulation.async_engine import FedBuffAPI as TFedBuffAPI
from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvgAPI
from fedml_tpu_torch.simulation.sp.fedavg_api import read_metrics

from .test_torch_obs_round import lanes_close, rows_close
from .torch_mesh_parity import jax_api
from .torch_sp_parity import port, port_tree, tiny

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import fedtrace  # noqa: E402

BYTES = ("collective_bytes", "collective_bytes_client",
         "collective_bytes_stage", "collective_bytes_model")


@pytest.fixture
def clean_tracers():
    for o in (j_obs, t_obs):
        o.configure(enabled=False)
        o.get_tracer().reset()
    yield
    for o in (j_obs, t_obs):
        o.configure(enabled=False)
        tr = o.get_tracer()
        tr.reset()
        tr.path = None


def flip_cfg(**over):
    """``tests/test_fedmon.py``'s ``_args_for``."""
    cfg = dict(dataset="synthetic", num_classes=10, input_shape=(28, 28, 1),
               train_size=4096, test_size=256, model="lr",
               client_num_in_total=64, client_num_per_round=32,
               comm_round=10, epochs=1, batch_size=16, learning_rate=0.1,
               random_seed=7, partition_method="homo",
               frequency_of_the_test=5, health=True, data_cache_dir="")
    cfg.update(over)
    return cfg


#: the FedBuff variant: the buffer is the cohort
FEDBUFF = dict(federated_optimizer="fedbuff", async_buffer_k=32,
               async_latency_median_s=5.0, async_latency_sigma=1.2,
               async_inflight_gens=3, frequency_of_the_test=4)


def flipped_clients(n_flip=6):
    rng = np.random.default_rng(0)
    return sorted(rng.choice(64, size=n_flip, replace=False).tolist())


def flip(dataset, flipped):
    for c in flipped:
        idx = dataset.client_idxs[c]
        dataset.train_y[idx] = (10 - 1) - dataset.train_y[idx]


def _flagged(kind):
    """The JAX engine's flagged set and the port's (sp/fused/FedBuff: the
    engine of the same kind; mesh: the port's mesh against the JAX sp
    engine), both from the JAX weights."""
    over = {"fused": dict(round_block=5, frequency_of_the_test=10 ** 9),
            "fedbuff": FEDBUFF}.get(kind, {})
    cfg = flip_cfg(**over)
    flipped = flipped_clients()
    jargs = fedml_tpu.init(j_arguments().update(**cfg))
    jds, jout = j_data.load(jargs)
    flip(jds, flipped)
    j_cls = JFedBuffAPI if kind == "fedbuff" else JFedAvgAPI
    japi = j_cls(jargs, None, jds, j_model.create(jargs, jout),
                 client_mode="vmap")
    targs = t_arguments().update(**cfg)
    tds, tout = t_data.load(targs)
    flip(tds, flipped)
    tmodel = t_model.create(targs, tout)
    if kind == "mesh":
        tapi = MeshFedAvgAPI(targs, "cpu", tds, tmodel)
    else:
        t_cls = TFedBuffAPI if kind == "fedbuff" else TFedAvgAPI
        tapi = t_cls(targs, "cpu", tds, tmodel, client_mode="vmap")
    tapi.reset_params(from_flax(jax.device_get(japi.state.global_params),
                                tmodel, device="cpu"))
    japi.train()
    tapi.train()
    return (japi.health_monitor.flagged(), tapi.health_monitor.flagged(),
            flipped, tapi)


@pytest.mark.parametrize("kind", ["sp", "fused", "fedbuff", "mesh"])
def test_label_flip_flags_match_jax(clean_tracers, kind):
    jflag, tflag, flipped, tapi = _flagged(kind)
    try:
        assert tflag == jflag == flipped, (kind, tflag, jflag, flipped)
        g = tapi.health_monitor.gauges()
        assert g["health.rounds_observed"] == 10.0
        if kind == "fedbuff":
            # real staleness flowed through the buffer's tau lane
            assert g["health.staleness_p99"] >= 1.0
    finally:
        if kind == "mesh":
            t_mesh.shutdown_world()


@pytest.mark.parametrize("sharding,block", [("replicated", 1),
                                            ("scatter", 2)])
def test_mesh_rows_and_lanes_match_jax_sp(clean_tracers, sharding, block):
    """The mesh engine on a world of 1 (both merge layouts, unfused and
    fused) against the JAX sp engine's rows and lanes."""
    cfg = tiny(comm_round=2, trace=True, health=True, round_block=block,
               update_sharding=sharding)
    japi = jax_api(JFedAvgAPI, cfg)
    mesh = port(MeshFedAvgAPI, t_arguments().update(**cfg))
    try:
        mesh.reset_params(port_tree(japi.state.global_params, mesh.model))
        for r in range(0, 2, block):
            if block == 1:
                jm, tm = japi.train_one_round(r), mesh.train_one_round(r)
                jrows = [j_obs_host(jm["obs"])]
                jlanes = [jm["health"]]
                _, ex = read_metrics(tm)
                trows, tlanes = [obs_host(ex["obs"])], [ex["health"]]
            else:
                (_, jm), (_, tm) = japi.train_block(r), mesh.train_block(r)
                jrows = j_obs_rows(jm["obs"])
                jlanes = [{k: np.asarray(v)[j]
                           for k, v in jm["health"].items()}
                          for j in range(block)]
                _, ex = read_metrics(tm)
                trows = obs_host_rows(ex["obs"])
                tlanes = [{k: v[j] for k, v in ex["health"].items()}
                          for j in range(block)]
            want_bytes = mesh.collective_bytes()
            for j in range(block):
                got, want = dict(trows[j]), dict(jrows[j])
                assert got["collective_bytes"] == want_bytes["total"]
                assert got["collective_bytes_client"] == \
                    want_bytes["client"]
                for k in BYTES:
                    got.pop(k), want.pop(k)
                rows_close(got, want, f"mesh round {r + j}")
                lanes_close(tlanes[j], jlanes[j], f"mesh round {r + j}")
    finally:
        if mesh._block_fn is not None:
            mesh._block_fn.release()
        t_mesh.shutdown_world()


def _audited(api, rounds, audit_from, block=1):
    losses, audit, r = [], TorchRuntimeAudit(), 0
    while r < rounds:
        def step():
            if block > 1:
                k, ms = api.train_block(r)
                return k, list(read_metrics(ms)[0])
            return 1, [float(read_metrics(api.train_one_round(r))[0])]
        if r >= audit_from:
            with audit:
                k, got = step()
        else:
            k, got = step()
        losses += got
        r += k
    return losses, audit


@pytest.mark.parametrize("kind", ["fedbuff", "mesh"])
def test_traced_engine_is_bitwise_untraced(clean_tracers, kind):
    """FedBuff's buffered path (fast path off) and the mesh's fused
    blocks: ``trace`` and ``health`` on change no loss and no param bit,
    and add no round build, capture or explicit transfer call."""
    if kind == "fedbuff":
        cfg = tiny(comm_round=5, federated_optimizer="fedbuff",
                   async_buffer_k=3, async_latency_median_s=2.0,
                   async_inflight_gens=2, async_fastpath=False)
        make = lambda c: port(TFedBuffAPI, t_arguments().update(**c))
        block = 1
    else:
        cfg = tiny(comm_round=6, round_block=2, update_sharding="scatter",
                   federated_optimizer="SCAFFOLD")
        make = lambda c: port(MeshFedAvgAPI, t_arguments().update(**c))
        block = 2
    try:
        off = make(cfg)
        l_off, a_off = _audited(off, 5 if block == 1 else 6, 2, block)
        on = make(dict(cfg, trace=True, health=True))
        l_on, a_on = _audited(on, 5 if block == 1 else 6, 2, block)
        assert l_on == l_off
        for k, v in off.state.global_params.items():
            assert torch.equal(on.state.global_params[k], v), k
        assert a_on.compilations == a_off.compilations == 0
        assert (a_on.device_puts, a_on.device_gets) == \
            (a_off.device_puts, a_off.device_gets)
        spans = t_obs.get_tracer().summary()["spans"]
        if kind == "fedbuff":
            assert spans["async.dispatch"]["count"] > 0
            assert spans["async.arrival"]["count"] > 0
            assert "async.staleness_p99" in \
                t_obs.get_tracer().summary()["counters"]
        else:
            assert spans["staging"]["count"] > 0
    finally:
        if kind == "mesh":
            for api in (off, on):
                if api._block_fn is not None:
                    api._block_fn.release()
            t_mesh.shutdown_world()


def test_fedtrace_summarize_reads_the_port_trace(clean_tracers, tmp_path):
    """``trace_path`` + ``trace_device`` (+ ``trace_profile_dir``) on the sp
    engine with the client store: the written trace validates, and
    ``fedtrace summarize`` (module and CLI) reports every round, the
    measured device phases and the store's spans."""
    path = str(tmp_path / "trace.json")
    prof = str(tmp_path / "prof")
    args = t_arguments().update(**tiny(
        comm_round=4, federated_optimizer="SCAFFOLD", client_store=True,
        trace=True, trace_path=path, trace_device=True,
        trace_profile_dir=prof))
    api = port(TFedAvgAPI, args)
    api.train()
    assert os.path.exists(os.path.join(prof, "trace_device.json"))
    trace = fedtrace.load_trace(path)
    assert fedtrace.validate_events(trace["traceEvents"]) == []
    s = fedtrace.summarize(trace)
    assert s["rounds"] == 4
    assert s["device_phase_source"] == "measured"
    assert set(s["phases"]) == {"staging", "gather", "client_steps",
                                "merge", "server_update"}
    assert s["phases"]["client_steps"] > 0.0
    spans = t_obs.get_tracer().summary()["spans"]
    for name in ("round", "staging", "eval", "store.page_in"):
        assert spans[name]["count"] > 0, name
    counters = t_obs.get_tracer().summary()["counters"]
    assert counters["store.page_in_bytes"] > 0
    assert "store.page_hit_rate" in counters
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                       "fedtrace.py"),
                          "summarize", path, "--json"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["rounds"] == 4


def test_engine_serves_metrics_and_healthz(clean_tracers, tmp_path):
    """``metrics_port=0`` behind the sp engine: ``/metrics`` carries the
    tracer's counters and the monitor's gauges, and a round-time SLO from
    ``health_slo_path`` with a crit bound turns ``/healthz`` to 503."""
    slo = tmp_path / "slo.yaml"
    slo.write_text("slos:\n  - {name: rt, metric: health.round_time_s, "
                   "max: 1.0e-9, crit: 1.0e-6}\n")
    args = t_arguments().update(**tiny(
        comm_round=3, trace=True, health=True, metrics_port=0,
        health_slo_path=str(slo), health_min_obs=1))
    api = port(TFedAvgAPI, args)
    srv = api.metrics_server
    try:
        assert srv.host == "127.0.0.1" and srv.port > 0
        with urllib.request.urlopen(srv.url + "/healthz", timeout=10) as r:
            assert json.loads(r.read().decode())["status"] == "ok"
        api.train()
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            samples = parse_prometheus_text(r.read().decode())
        assert prom_value(samples, "fedmon_gauge",
                          name="health.rounds_observed") == 3.0
        assert prom_value(samples, "fedtrace_span_count",
                          name="round") == 3.0
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/healthz", timeout=10)
        assert e.value.code == 503
    finally:
        srv.close()


@pytest.mark.parametrize("alg,over,what", [
    ("dsgd", dict(trace=True), "trace"),
    ("dsgd", dict(metrics_port=0), "metrics_port"),
    ("async_fedavg", dict(health=True), "health"),
    ("HierarchicalFL", dict(health=True), "health"),
    ("FedAvg", dict(trace=True, trace_device=True, device_data=False),
     "trace_device")])
def test_engines_without_the_obs_plane_refuse_it_by_name(clean_tracers, alg,
                                                         over, what):
    """An engine that does not wire an obs option raises naming it: the
    decentralized engine (no obs plane), ``health`` where the rounds
    return no per-client lanes, ``trace_device`` where the probe cannot
    split the round (host-staged data)."""
    from fedml_tpu_torch.runner import FedMLRunner
    cfg = tiny(federated_optimizer=alg, **over)
    if alg == "dsgd":
        cfg.update(topology="symmetric", topology_neighbors=2)
    if alg == "HierarchicalFL":
        cfg.update(group_num=2, group_comm_round=1)
    args = t_arguments().update(**cfg)
    ds, out = t_data.load(args)
    with pytest.raises(NotImplementedError, match=what):
        FedMLRunner(args, torch.device("cpu"), ds, t_model.create(args, out))
