"""The port's multi-rank buffered-async driver
(``simulation/async_driver.py``) against its in-process engine
(``FedBuffAPI``), a server and its workers as threads over ``local``.

- one worker with a buffer of one: every apply is one fresh generation at
  zero staleness, so the driver is the in-process engine's atomic-cohort
  rounds (K = the cohort, zero latency) up to reassociation;
- two workers, int8 wire with per-worker EF links and ``wire_overlap``:
  the driver applies ``comm_round`` times with finite losses, and its
  final params stay within a bound of the in-process engine buffering two
  generations.  Arrival order follows the threads, so this run is held to
  a bound, never bitwise (tests/test_wire.py says the same of the JAX
  driver);
- one worker at int8 with ``wire_overlap`` against the JAX package's
  driver from the same weights: one worker fixes the arrival order, so
  every apply's loss and the final params hold JAX's within 2e-5;
- stateful algorithms are refused.
"""

import threading

import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.core.distributed.communication.local import (
    local_comm_manager)
from fedml_tpu_torch.simulation.async_driver import run_async_federation
from fedml_tpu_torch.simulation.async_engine import FedBuffAPI
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

#: tests/test_wire.py's async-driver config
CFG = dict(dataset="synthetic", num_classes=10, input_shape=(14, 14, 1),
           train_size=512, test_size=128, model="lr",
           client_num_in_total=12, client_num_per_round=8, comm_round=3,
           epochs=1, batch_size=16, learning_rate=0.1, random_seed=5,
           frequency_of_the_test=100, federated_optimizer="fedbuff",
           data_cache_dir="", comm_recv_timeout_s=30.0)
#: the one-worker driver against the in-process rounds: reassociation
#: of the partial {num, den} against the stacked average
REASSOC_TOL = 2e-5
#: two workers: the L2 distance of the final params from the in-process
#: engine's, over the distance the in-process engine moved them from the
#: initial weights (0.16-0.25 over six runs' arrival orders on the CPU)
ASYNC_REL_BOUND = 0.5
JOIN_S = 60.0
#: one worker at int8 (a per-worker EF link, the writer thread), against
#: the JAX driver; at an input shape of its own, so that the JAX
#: package's two-worker test (tests/test_wire.py, held to a bound over
#: thread arrival order) compiles its programs afresh in a shared worker
#: process, as it does alone
ONE_INT8 = dict(CFG, federated_optimizer="fedavg", async_workers=1,
                async_buffer_k=1, wire_precision="int8", wire_block=16,
                wire_overlap=True, input_shape=(12, 12, 1))


def args_for(**over):
    return fedml_tpu_torch.init(
        fedml_tpu_torch.load_arguments().update(**dict(CFG, **over)),
        should_init_logs=False)


def federate(run_id, workers, **over):
    """The server and ``workers`` workers as threads; returns the
    server's history and its API."""
    out, errors = {}, []

    def run(rank):
        try:
            a = args_for(async_workers=workers, rank=rank, backend="local",
                         run_id=run_id, **over)
            ds, n = t_data.load(a)
            model = t_model.create(a, n)
            a.federated_optimizer = "fedavg"
            api = FedAvgAPI(a, "cpu", ds, model)
            out[rank] = run_async_federation(a, "cpu", ds, model, api=api)
            out[f"api{rank}"] = api
        except BaseException as e:   # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(workers, -1, -1)]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join(timeout=JOIN_S)
    finally:
        local_comm_manager.reset_run(run_id)
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads), "federation deadlocked"
    return out[0], out["api0"]


def fedbuff(k):
    a = args_for(async_buffer_k=k)
    ds, n = t_data.load(a)
    api = FedBuffAPI(a, "cpu", ds, t_model.create(a, n))
    init = {k: v.clone() for k, v in api.state.global_params.items()}
    losses = [float(api.train_one_round(r)["train_loss"]) for r in range(3)]
    return losses, api.state.global_params, init


def dist(a, b):
    return float(torch.sqrt(sum(torch.sum((a[k] - b[k]) ** 2) for k in a)))


def test_one_worker_is_the_in_process_rounds():
    hist, api = federate("t_async_one", 1, async_buffer_k=1)
    losses, params, _ = fedbuff(CFG["client_num_per_round"])
    assert [h["round"] for h in hist] == [0, 1, 2]
    assert [h["staleness_p50"] for h in hist] == [0.0] * 3
    assert np.max(np.abs(np.subtract([h["train_loss"] for h in hist],
                                     losses))) < REASSOC_TOL
    for k, v in params.items():
        torch.testing.assert_close(api.state.global_params[k], v, rtol=0,
                                   atol=REASSOC_TOL)


def test_two_workers_int8_overlap_within_bound():
    hist, api = federate("t_async_int8", 2, async_buffer_k=2,
                         wire_precision="int8", wire_block=16,
                         wire_overlap=True)
    assert len(hist) == CFG["comm_round"]
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    assert all(h["buffer_fill"] == 2 for h in hist)
    _, params, init = fedbuff(2 * CFG["client_num_per_round"])
    rel = dist(api.state.global_params, params) / dist(params, init)
    assert rel < ASYNC_REL_BOUND, rel


def test_one_worker_int8_matches_jax(monkeypatch):
    import fedml_tpu.simulation.async_driver as j_async

    from .torch_wire_parity import assert_params_close, losses, pair
    j_hist, t_hist, j_params, t_params = pair(
        monkeypatch, ONE_INT8, "t_async_jax", j_async, "FedAvgAPI",
        j_async.run_async_federation, FedAvgAPI, run_async_federation,
        [1, 0])
    assert [h["round"] for h in t_hist] == [h["round"] for h in j_hist] \
        == list(range(CFG["comm_round"]))
    np.testing.assert_allclose(losses(t_hist), losses(j_hist), rtol=0,
                               atol=REASSOC_TOL)
    assert_params_close(t_params, j_params)


def test_stateful_algorithms_are_refused():
    a = args_for(federated_optimizer="SCAFFOLD", rank=1, backend="local",
                 run_id="t_async_refuse")
    ds, n = t_data.load(a)
    with pytest.raises(ValueError, match="stateless-client"):
        run_async_federation(a, "cpu", ds, t_model.create(a, n))
