"""The port's buffered-async engine (``simulation/async_engine.py``, its
buffer algebra in ``core/federated.py``, ``core/traffic.py`` and
``simulation/async_sim.py``) against the JAX package's, on the CPU,
numpy-seeded, at ``tests/test_async_engine.py``'s sizes:

- the traffic draws and the ``ArrivalSimulator``'s events bitwise JAX's
  (host numpy copies);
- the buffer algebra (discount, apply, padding sentinel, discounted
  partials) against JAX's on the same rows;
- the zero-staleness run bitwise the sync engine in the port (the
  atomic-cohort fast path), and the buffered path within float tolerance;
- a heavy-tailed run (stragglers, dropout, a staleness cap) within the sp
  parity tolerance of JAX ``FedBuffAPI``'s losses and params, with equal
  staleness, drop and dispatch counts;
- the store-backed run bitwise the dense one; ``run_simulation`` routes
  ``fedbuff``; the lockstep options are refused.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu.core import federated as j_fed
from fedml_tpu.core import hostrng as j_hostrng
from fedml_tpu.core import traffic as j_traffic
from fedml_tpu.simulation.async_engine import FedBuffAPI as JFedBuffAPI
from fedml_tpu.simulation.async_sim import ArrivalSimulator as JSim
from fedml_tpu_torch.core import federated as t_fed
from fedml_tpu_torch.core import hostrng as t_hostrng
from fedml_tpu_torch.core import traffic as t_traffic
from fedml_tpu_torch.simulation.async_engine import FedBuffAPI
from fedml_tpu_torch.simulation.async_sim import ArrivalSimulator
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

from .torch_sp_parity import TOL, base_args, build, port, port_tree, tree_close

CFG = dict(dataset="synthetic", num_classes=10, input_shape=(14, 14, 1),
           train_size=512, test_size=128, model="lr",
           client_num_in_total=12, client_num_per_round=8, comm_round=4,
           epochs=1, batch_size=16, learning_rate=0.1, random_seed=5,
           frequency_of_the_test=100, data_cache_dir="")


def _args(**over):
    return base_args(**{**CFG, **over})


def test_traffic_draws_are_bitwise_jax():
    for fn, args in (("zipf_weights", (50, 1.1)),):
        np.testing.assert_array_equal(getattr(t_traffic, fn)(*args),
                                      getattr(j_traffic, fn)(*args))
    for fn, args in (("poisson_arrivals", (3.0, 40)),
                     ("lognormal_sizes", (64.0, 0.8, 40, 1, 300)),
                     ("lognormal_latencies", (2.0, 1.6, 40)),
                     ("bernoulli", (0.3, 40)), ("bernoulli", (0.0, 5))):
        got = getattr(t_traffic, fn)(t_hostrng.gen(7, 1), *args)
        want = getattr(j_traffic, fn)(j_hostrng.gen(7, 1), *args)
        np.testing.assert_array_equal(got, want, err_msg=fn)


def test_arrival_simulator_events_are_bitwise_jax():
    kw = dict(seed=3, latency_median_s=2.0, latency_sigma=1.6, dropout=0.2,
              speed_sigma=0.5, unavailable_p=0.3, unavailable_mean_s=4.0)
    jsim, tsim = JSim(**kw), ArrivalSimulator(**kw)
    rng = np.random.default_rng(0)
    for g in range(5):
        clients = rng.choice(1000, 6, replace=False)
        jsim.dispatch(g, g // 2, clients)
        tsim.dispatch(g, g // 2, clients)
        assert [vars(e) for e in tsim.peek_next(4)] == \
            [vars(e) for e in jsim.peek_next(4)]
        for _ in range(3):
            assert vars(tsim.next_arrival()) == vars(jsim.next_arrival())
            assert tsim.now == jsim.now
    while (je := jsim.next_arrival()) is not None:
        assert vars(tsim.next_arrival()) == vars(je)
    assert tsim.next_arrival() is None and tsim.now == jsim.now
    zero = ArrivalSimulator(seed=1, latency_median_s=0.0)
    zero.dispatch(0, 0, [9, 4, 7])
    assert [zero.next_arrival().slot for _ in range(3)] == [0, 1, 2]


def _outs(c, seed=0):
    rng = np.random.default_rng(seed)
    stacked = {"w": rng.standard_normal((c, 2, 3)).astype(np.float32),
               "b": rng.standard_normal((c, 3)).astype(np.float32)}
    w = np.arange(1.0, c + 1.0, dtype=np.float32)
    loss = rng.random(c).astype(np.float32)
    return stacked, w, loss


def _ns(stacked, loss, lib):
    conv = (lambda a: jnp.asarray(a)) if lib == "j" else torch.from_numpy
    return types.SimpleNamespace(params={k: conv(v) for k, v in
                                         stacked.items()}, loss=conv(loss))


def test_buffer_algebra_matches_jax():
    """K=4 rows with staleness (0, 1, 2, 0) and one padding lane: the
    discount, the apply's aggregate, the reset buffer and the discounted
    partials equal JAX's on the same rows."""
    np.testing.assert_array_equal(
        t_fed.staleness_discount([0.0, 1.0, 3.0], 0.5).numpy(),
        np.asarray(j_fed.staleness_discount(jnp.asarray([0.0, 1.0, 3.0]),
                                            0.5)))
    assert float(t_fed.staleness_discount([0.0], 0.5)[0]) == 1.0
    c = 4
    stacked, w, loss = _outs(c)
    tau = np.asarray([0.0, 1.0, 2.0, 0.0], np.float32)
    s = (1.0 + tau) ** -0.5
    idx, slots = np.asarray([3, 1, 0, 2, 1]), np.asarray([0, 1, 2, 3, 4])
    res = {}
    for lib, fed in (("j", j_fed), ("t", t_fed)):
        spec = fed.get_spec("fedavg")
        opt = types.SimpleNamespace(
            algorithm="fedavg", spec=spec,
            update_from_aggregates=lambda st, a, hp=None: a)
        outs = _ns(stacked, loss, lib)
        conv = jnp.asarray if lib == "j" else torch.as_tensor
        rows = fed.client_update_rows(spec, opt, types.SimpleNamespace(
            global_params=outs.params), outs, conv(w))
        buf = fed.update_buffer_zeros(spec, rows, c)
        buf = fed.update_buffer_add(buf, rows, idx,
                                    slots, np.append(s, 9.0),
                                    np.append(tau, 9.0))
        assert float(buf["occupancy"]) == c
        _, agg, fresh = fed.update_buffer_apply(spec, opt, None, buf)
        assert float(fresh["occupancy"]) == 0.0
        assert float(fresh["version"]) == 1.0
        res[lib] = {k: np.asarray(v) for k, v in agg["avg_params"].items()}
        res[lib + "n"] = float(agg["n_sampled"])
        part = {"n_sampled": conv(np.float32(3.0)),
                "avg_params": {"num": {k: conv(v[0]) for k, v in
                                       stacked.items()},
                               "den": conv(np.float32(2.0))}}
        sp = fed.scale_partial(spec, part, 0.5)
        res[lib + "p"] = (float(sp["n_sampled"]),
                          float(sp["avg_params"]["den"]),
                          np.asarray(sp["avg_params"]["num"]["w"]))
    for k in res["t"]:
        np.testing.assert_allclose(res["t"][k], res["j"][k], rtol=0,
                                   atol=1e-6)
    # the closed form: the staleness-weighted average of the landed rows
    eff = s * w[idx[:4]]
    want = sum(eff[i] / eff.sum() * stacked["w"][idx[i]] for i in range(c))
    np.testing.assert_allclose(res["t"]["w"], want, atol=1e-6)
    assert res["tn"] == res["jn"] == pytest.approx(float(s.sum()))
    assert res["tp"][:2] == res["jp"][:2]
    np.testing.assert_array_equal(res["tp"][2], res["jp"][2])


@pytest.mark.parametrize("alg", ["FedAvg", "FedOpt", "SCAFFOLD"])
def test_zero_staleness_run_is_bitwise_the_sync_engine(alg):
    """K = cohort, zero latency: the fast path runs the sync round program,
    params and (SCAFFOLD) the client table bitwise."""
    sync = port(FedAvgAPI, _args(federated_optimizer=alg))
    ab = port(FedBuffAPI, _args(federated_optimizer="fedbuff",
                                async_base_optimizer=alg.lower()))
    for r in range(4):
        sync.train_one_round(r)
        m = ab.train_one_round(r)
    for k, v in sync.state.global_params.items():
        assert torch.equal(v, ab.state.global_params[k]), k
    if sync.client_table is not None:
        for k, v in sync.client_table.items():
            assert torch.equal(v, ab.client_table[k]), k
    assert ab.fastpath_applies == 4 and m["staleness_p50"] == 0.0
    assert float(m["buffer_occupancy"]) == ab.buffer_k


def test_buffered_path_matches_sync_with_zero_staleness():
    sync = port(FedAvgAPI, _args(federated_optimizer="FedAvg"))
    ab = port(FedBuffAPI, _args(federated_optimizer="fedbuff",
                                async_fastpath=False))
    for r in range(3):
        sm = sync.train_one_round(r)
        m = ab.train_one_round(r)
        assert abs(float(m["train_loss"]) - float(sm["train_loss"])) < 2e-6
    assert ab.fastpath_applies == 0 and float(m["staleness_max"]) == 0.0
    for k, v in sync.state.global_params.items():
        assert float((v - ab.state.global_params[k]).abs().max()) < 2e-6


HEAVY = dict(federated_optimizer="fedbuff", async_latency_median_s=2.0,
             async_latency_sigma=1.6, async_inflight_gens=2,
             async_dropout=0.15, async_max_staleness=3, comm_round=6)


@pytest.mark.parametrize("base", ["fedavg", "scaffold"])
def test_heavy_tail_run_matches_jax(base):
    cfg = dict(CFG, async_base_optimizer=base, **HEAVY)
    japi, tapi, model = build(cfg, JFedBuffAPI, FedBuffAPI)
    tapi.state = tapi.state.replace(
        global_params=port_tree(japi.state.global_params, model))
    stale = False
    for r in range(6):
        jm = japi.train_one_round(r)
        tm = tapi.train_one_round(r)
        assert abs(float(tm["train_loss"]) - float(jm["train_loss"])) < TOL
        for key in ("staleness_p50", "staleness_p99", "sim_time_s",
                    "updates_dropped", "clients_dispatched"):
            assert tm[key] == jm[key], (r, key)
        assert float(tm["staleness_max"]) == float(jm["staleness_max"])
        stale |= tm["staleness_p99"] > 0
    tree_close(tapi.state.global_params, japi.state.global_params, model,
               "params")
    assert stale and tapi.updates_dropped > 0
    assert tapi.fastpath_applies == japi.fastpath_applies < 6
    assert tapi.updates_buffered == japi.updates_buffered


def test_store_backed_run_is_bitwise_the_dense_run():
    over = dict(federated_optimizer="fedbuff",
                async_base_optimizer="scaffold", registered_clients=64,
                async_latency_median_s=1.0, async_inflight_gens=2)
    dense = port(FedBuffAPI, _args(**over))
    store = port(FedBuffAPI, _args(client_store=True, store_page_size=8,
                                   **over))
    for r in range(4):
        dense.train_one_round(r)
        store.train_one_round(r)
    store._pager.drain_writebacks()
    for k, v in dense.state.global_params.items():
        assert torch.equal(v, store.state.global_params[k]), k
    ids = np.arange(64)
    rows = store._store.gather(ids)
    for k, v in dense.client_table.items():
        np.testing.assert_array_equal(v.numpy(), rows[k], err_msg=k)
    assert store._store.stats()["touched_rows"] > 0


def test_run_simulation_routes_fedbuff_and_refuses_lockstep_options():
    args = _args(federated_optimizer="FedBuff", comm_round=3,
                 async_latency_median_s=1.0)
    params = fedml_tpu_torch.run_simulation(backend="sp", args=args,
                                            device="cpu")
    assert all(bool(torch.isfinite(v).all()) for v in params.values())
    for over, what in ((dict(round_block=2), "round_block"),
                       (dict(cohort_bucketing=True), "cohort_bucketing"),
                       (dict(collective_precision="bf16"),
                        "collective_precision")):
        with pytest.raises(ValueError, match=what):
            port(FedBuffAPI, _args(federated_optimizer="fedbuff", **over))
    assert t_fed.check_algorithm("FedBuff") == "fedbuff"
