"""The port's per-round obs rows and health lanes against the JAX sp
engine's, on the CPU, and the obs plane's zero-overhead contract.

Both engines start from the JAX engine's weights (carried across by
``models/convert.py``) and see the same cohorts, batch schedules and step
masks (bitwise-equal host streams).  Per round, unfused and under
``round_block``, the port's ObsCarry row (``obs.round``) and ``(C,)``
health lanes are held to the JAX engine's:

- counts (steps, clients, examples, the FLOP weights, the byte models) and
  the weight lane: exactly;
- the update norm and the norm, cosine and loss-delta lanes: within 1e-5
  relative (f32), a lane's error over the lane's largest magnitude (the
  cosine and loss-delta lanes cross zero, where a per-element ratio means
  nothing).

A traced run (``trace``, ``health``, ``metrics_port``) is bitwise an
untraced one (losses and params), with zero extra round builds, graph
captures and explicit transfers by ``TorchRuntimeAudit``."""

import numpy as np
import pytest
import torch

from fedml_tpu import obs as j_obs
from fedml_tpu.core import federated as j_fed
from fedml_tpu.obs.carry import obs_host as j_obs_host
from fedml_tpu.obs.carry import obs_host_rows as j_obs_rows
from fedml_tpu.obs.carry import obs_population_rows as j_pop_rows
from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI

from fedml_tpu_torch import obs as t_obs
from fedml_tpu_torch.analysis import TorchRuntimeAudit
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.obs.carry import (obs_host, obs_host_rows,
                                       obs_population_rows)
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvgAPI
from fedml_tpu_torch.simulation.sp.fedavg_api import read_metrics

from .torch_sp_parity import build, port, port_tree, tiny

TOL = 1e-5
#: ObsCarry fields that are counts or static models: equal exactly
EXACT = ("steps", "clients", "examples", "flops_gather",
         "flops_client_steps", "flops_merge", "flops_server_update",
         "collective_bytes", "collective_bytes_client",
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


def rows_close(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        if k in EXACT or k == "quant_error_norm" and v == 0.0:
            assert got[k] == v, (what, k, got[k], v)
        elif isinstance(v, float):
            assert abs(got[k] - v) <= TOL * max(abs(v), 1e-30), \
                (what, k, got[k], v)


def lanes_close(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        v = np.asarray(v, np.float64)
        g = np.asarray(got[k], np.float64)
        assert g.shape == v.shape, (what, k)
        if k == "weight":
            np.testing.assert_array_equal(g, v, err_msg=f"{what} {k}")
        else:
            scale = max(float(np.max(np.abs(v))), 1e-30)
            assert float(np.max(np.abs(g - v))) <= TOL * scale, (what, k)


def pair(cfg):
    """The JAX engine and the port's, the port from the JAX weights (a
    population's member 0: every member starts there)."""
    japi, tapi, model = build(cfg, JFedAvgAPI, TFedAvgAPI)
    params = japi.state.global_params
    if japi.population:
        params = j_fed.population_member(params, 0)
    tapi.reset_params(port_tree(params, model))
    return japi, tapi


@pytest.mark.parametrize("alg,block", [("FedAvg", 1), ("FedAvg", 2),
                                       ("SCAFFOLD", 2)])
def test_obs_rows_and_health_lanes_match_jax(clean_tracers, alg, block):
    """Per round, unfused (``train_one_round``) and fused (``train_block``:
    the port's rows ride the captured graph's static output, stacked
    ``(K,)`` / ``(K, C)``), on ragged clients; SCAFFOLD adds the client
    table."""
    rounds = 4
    japi, tapi = pair(tiny(comm_round=rounds, trace=True, health=True,
                           federated_optimizer=alg, round_block=block))
    for r in range(0, rounds, block):
        if block == 1:
            jm, tm = japi.train_one_round(r), tapi.train_one_round(r)
            jrows = [j_obs_host(jm["obs"])]
            jlanes = [jm["health"]]
            _, ex = read_metrics(tm)
            trows = [obs_host(ex["obs"])]
            tlanes = [ex["health"]]
        else:
            (_, jm), (_, tm) = japi.train_block(r), tapi.train_block(r)
            jrows = j_obs_rows(jm["obs"])
            jlanes = [{k: np.asarray(v)[j] for k, v in jm["health"].items()}
                      for j in range(block)]
            _, ex = read_metrics(tm)
            trows = obs_host_rows(ex["obs"])
            tlanes = [{k: v[j] for k, v in ex["health"].items()}
                      for j in range(block)]
        assert len(trows) == len(jrows) == block
        for j in range(block):
            rows_close(trows[j], jrows[j], f"{alg} round {r + j}")
            lanes_close(tlanes[j], jlanes[j], f"{alg} round {r + j}")
            assert trows[j]["update_norm"] > 0


def test_population_obs_rows_match_jax(clean_tracers):
    """A population of two client learning rates in a fused block: the
    member-mean rows and the best / worst / mean member losses (the port
    stacks a block's obs leaves ``(K, P)``, the JAX scan ``(P, K)``)."""
    japi, tapi = pair(tiny(comm_round=2, round_block=2, trace=True,
                           population_axes={"client_lr": [0.05, 0.1]}))
    (_, jm), (_, tm) = japi.train_block(0), tapi.train_block(0)
    jr = j_pop_rows(jm["obs"], np.asarray(jm["train_loss"]))
    losses, ex = read_metrics(tm)
    tr = obs_population_rows(ex["obs"], losses)
    assert len(tr) == len(jr) == 2
    for j, (a, b) in enumerate(zip(tr, jr)):
        assert a["members"] == b["members"] == 2.0
        assert a["member_bytes_spread"] == 0.0
        rows_close(a, b, f"population round {j}")


def _run(cfg, audit_from):
    """Train ``cfg`` on the port; the rounds from ``audit_from`` on run
    under a ``TorchRuntimeAudit``.  Returns (api, losses, audit)."""
    api = port(TFedAvgAPI, t_arguments().update(**cfg))
    block = int(cfg.get("round_block", 1))
    losses, r = [], 0
    audit = TorchRuntimeAudit()
    while r < api.comm_rounds:
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
    return api, losses, audit


@pytest.mark.parametrize("block", [1, 2])
def test_traced_run_is_bitwise_untraced_with_no_extra_work(clean_tracers,
                                                           block):
    """``trace``/``health``/``metrics_port`` on: the same losses and params
    bit for bit, and over the steady-state rounds the same round builds,
    graph captures and explicit transfers (calls and bytes but the obs
    rows' and lanes' own bytes, which ride the loss's copy)."""
    cfg = tiny(comm_round=6, round_block=block, federated_optimizer="SCAFFOLD",
               frequency_of_the_test=10 ** 9)
    off, l_off, a_off = _run(cfg, audit_from=2)
    t_obs.get_tracer().reset()
    on, l_on, a_on = _run(dict(cfg, trace=True, health=True,
                               metrics_port=0), audit_from=2)
    try:
        assert t_obs.trace_enabled() and on.health_monitor is not None
        assert on.metrics_server is not None and on.metrics_server.port > 0
        assert l_on == l_off
        for k, v in off.state.global_params.items():
            assert torch.equal(on.state.global_params[k], v), k
        for k, v in off.client_table.items():
            assert torch.equal(on.client_table[k], v), k
        assert a_on.compilations == a_off.compilations == 0
        assert (a_on.device_puts, a_on.device_gets, a_on.put_bytes) == \
            (a_off.device_puts, a_off.device_gets, a_off.put_bytes)
        assert a_off.device_gets > 0
        assert a_on.get_bytes > a_off.get_bytes
        assert a_on.syncs is None      # sync debug mode watches the card
    finally:
        on.metrics_server.close()


def test_quantized_rounds_report_the_residual(clean_tracers):
    """A bf16 collective round's row: the residual norm of the merge and
    broadcast quantization is positive and finite, and the byte model is
    the bf16 payload's (half the fp32 row's)."""
    rows = {}
    for prec in ("fp32", "bf16"):
        t_obs.configure(enabled=True, reset=True)
        api = port(TFedAvgAPI, t_arguments().update(**tiny(
            comm_round=2, collective_precision=prec)))
        _, ex = read_metrics(api.train_one_round(0))
        rows[prec] = obs_host(ex["obs"])
        t_obs.configure(enabled=False)
    assert rows["fp32"]["quant_error_norm"] == 0.0
    assert 0.0 < rows["bf16"]["quant_error_norm"] < float("inf")
    assert rows["bf16"]["collective_bytes"] * 2 == \
        rows["fp32"]["collective_bytes"]
