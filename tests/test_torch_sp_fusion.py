"""The port's fused round blocks (``round_block``), its async cohort stager
and its cohort bucketing against the JAX package's, on the CPU.

Mirrors ``tests/test_round_fusion.py`` (the sp cases and the stager) and
``tests/test_e2e_sp.py::test_cohort_bucketing_matches_unbucketed``.  Both
engines start from the same weights (the JAX init carried across by
``models/convert.py``) and see the same cohorts, batch schedules and step
masks (bitwise-equal host streams).

Tolerances:

- the port's fused block against the port's own rounds one by one:
  bitwise (per-round losses, params, server state, table rows); on the
  CPU a block is a plain loop over its rounds, each at its own step
  class;
- the port against the JAX package: 1e-5 (absolute) on params, losses,
  server state and table rows.  FedOpt's server Adam runs at
  ``server_lr`` 0.03 in the JAX comparisons: at its default 1.0 its
  normalised step turns f32 summation-order noise into steps of order
  ``server_lr`` (``tests/test_torch_sp_algorithms.py``);
- bucketed against unbucketed, within the port: equal ``total_steps``,
  strictly fewer ``allocated_steps``, evaluation loss within 2e-4 and
  accuracy within 2e-2 (the JAX test's bars).
"""

import time

import numpy as np
import pytest
import torch

from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI

from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvgAPI
from fedml_tpu_torch.simulation.staging import AsyncCohortStager

from .torch_sp_parity import (TOL, build, port, port_tree, state_close,
                              table_close)

ALGS = ["FedAvg", "FedOpt", "SCAFFOLD", "FedDyn"]


def fusion_cfg(rounds=5, **over):
    """``tests/test_round_fusion.py``'s ``args_for``."""
    cfg = dict(dataset="synthetic", num_classes=10, input_shape=(28, 28, 1),
               train_size=1024, test_size=256, model="lr",
               client_num_in_total=16, client_num_per_round=8,
               comm_round=rounds, epochs=1, batch_size=16,
               learning_rate=0.1, random_seed=7,
               frequency_of_the_test=10 ** 9, data_cache_dir="")
    cfg.update(over)
    return cfg


def pair(cfg):
    """The JAX engine and the port's (on the CPU, from the JAX weights)."""
    japi, tapi, model = build(cfg, JFedAvgAPI, TFedAvgAPI)
    tapi.state = tapi.state.replace(
        global_params=port_tree(japi.state.global_params, model))
    return japi, tapi, model


def twin(tapi, **over):
    """A second port engine of ``tapi``'s config with ``over`` set, from
    ``tapi``'s current weights."""
    args = t_arguments().update(**dict(vars(tapi.args), **over))
    other = port(TFedAvgAPI, args)
    other.state = other.state.replace(global_params={
        k: v.clone() for k, v in tapi.state.global_params.items()})
    return other


def run_per_round(api, rounds):
    return [float(api.train_one_round(r)["train_loss"])
            for r in range(rounds)]


def run_fused(api, rounds):
    losses, r = [], 0
    while r < rounds:
        k, ms = api.train_block(r)
        losses += [float(x) for x in np.asarray(ms["train_loss"])]
        r += k
    return losses


def assert_bitwise(a, b):
    """Two port engines' server state and client table are bitwise
    equal."""
    for f in ("global_params", "opt_state", "c_server", "h", "momentum"):
        da, db = getattr(a.state, f), getattr(b.state, f)
        assert (da is None) == (db is None), f
        for k in (da or {}):
            assert torch.equal(da[k], db[k]), (f, k)
    assert a.state.round_idx == b.state.round_idx
    assert (a.client_table is None) == (b.client_table is None)
    for k in (a.client_table or {}):
        assert torch.equal(a.client_table[k], b.client_table[k]), k


# -- fused ≡ per-round --------------------------------------------------------

@pytest.mark.parametrize("opt", ALGS)
def test_fused_block_matches_per_round(opt):
    """K=2 over 5 rounds: blocks of 2+2+1, the last a ragged tail.  The
    port's fused block equals its rounds one by one bitwise, and the JAX
    package's fused block to 1e-5 (params, per-round losses, server state,
    table rows)."""
    over = dict(federated_optimizer=opt)
    if opt == "FedOpt":
        over.update(server_lr=0.03)
    japi, ref, model = pair(fusion_cfg(round_block=2, **over))
    fused = twin(ref)
    ref_losses = run_per_round(ref, 5)
    fused_losses = run_fused(fused, 5)
    assert ref_losses == fused_losses
    assert_bitwise(ref, fused)
    j_losses = run_fused(japi, 5)
    assert np.allclose(fused_losses, j_losses, rtol=0, atol=TOL), (
        fused_losses, j_losses)
    state_close(japi, fused, model)
    table_close(japi, fused, model)


def test_fused_block_with_dropout_matches_per_round():
    """The CNN with dropout on a ragged split, blocks (3+2) that mix step
    classes: each round runs at its own class with its masks drawn at it,
    so the blocks equal the rounds one by one bitwise and allocate each
    round's own steps."""
    cfg = t_arguments().update(**fusion_cfg(
        model="cnn", input_shape=(14, 14, 1), train_size=384, test_size=96,
        client_num_in_total=10, client_num_per_round=2, random_seed=11,
        partition_method="hetero", partition_alpha=0.3, round_block=3))
    ref = port(TFedAvgAPI, cfg)
    fused = twin(ref)
    steps = [ref._stage_round_arrays(r)[4] for r in range(5)]
    assert len(set(steps)) > 1, steps      # blocks mix step classes
    assert run_per_round(ref, 5) == run_fused(fused, 5)
    assert_bitwise(ref, fused)
    allocated = np.concatenate([fused.train_block(r)[1]["allocated_steps"]
                                for r in (0, 3)])
    assert allocated.tolist() == [2 * s for s in steps]


def test_fused_train_driver_end_to_end():
    """``train()`` with round_block=3 over 5 rounds (3+2 blocks): one
    record per round with host-float losses, the same curve as the
    unfused loop (bitwise) and as the JAX package's fused loop (1e-5),
    the evaluation attached at the last round of each block holding a log
    round."""
    japi, fused, model = pair(fusion_cfg(federated_optimizer="SCAFFOLD",
                                         round_block=3,
                                         frequency_of_the_test=2))
    ref = twin(fused, round_block=1)
    ref.train()
    fused.train()
    japi.train()
    assert [r["round"] for r in fused.metrics_history] == list(range(5))
    assert [r["train_loss"] for r in ref.metrics_history] == \
        [r["train_loss"] for r in fused.metrics_history]
    assert all(isinstance(r["train_loss"], float)
               for r in fused.metrics_history)
    assert_bitwise(ref, fused)
    assert "test_acc" in fused.metrics_history[2]   # block 0..2 (round 2)
    assert "test_acc" in fused.metrics_history[4]   # final block
    assert [set(r) for r in fused.metrics_history] == \
        [set(r) for r in japi.metrics_history]
    for t, j in zip(fused.metrics_history, japi.metrics_history):
        for key in ("train_loss", "test_loss", "test_acc"):
            if key in j:
                assert abs(t[key] - j[key]) < TOL, (key, t, j)
    state_close(japi, fused, model)
    table_close(japi, fused, model)
    # the unfused loop defers the sync to log rounds but records every
    # round as floats
    assert [r["round"] for r in ref.metrics_history] == list(range(5))
    assert all(isinstance(r["train_loss"], float)
               for r in ref.metrics_history)


def test_round_block_rejects_unfusable_configs():
    args = lambda **over: t_arguments().update(**fusion_cfg(**over))
    with pytest.raises(ValueError, match="unbucketed"):
        port(TFedAvgAPI, args(round_block=4, cohort_bucketing=True))
    # host-data mode: block staging would ship whole cohorts, not indices
    api = port(TFedAvgAPI, args(round_block=4, device_data=False))
    with pytest.raises(ValueError, match="device-gather"):
        api.train_block(0)
    # a subclass with its own round loop refuses the flag loudly
    from fedml_tpu_torch.simulation.sp.hierarchical_fl import \
        HierarchicalFedAvgAPI
    with pytest.raises(ValueError, match="round_block"):
        port(HierarchicalFedAvgAPI, args(
            federated_optimizer="HierarchicalFL", group_num=4,
            group_comm_round=2, round_block=4))


def test_block_staging_checks_table_ids():
    """The block indexes the client table with its cohort ids on the
    device, where an out-of-range id cannot be dropped: staging refuses
    one, naming the round."""
    api = port(TFedAvgAPI, t_arguments().update(**fusion_cfg(
        federated_optimizer="SCAFFOLD", round_block=2)))
    api._client_sampling = lambda r: np.arange(8) + 9
    with pytest.raises(ValueError, match="round 0"):
        api._stage_block(0)


# -- the async cohort stager --------------------------------------------------

def _wait_for(cond, timeout=5.0):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout:
            raise AssertionError("condition not reached in time")
        time.sleep(0.01)


def test_stager_reraises_worker_failure_promptly():
    """A build exception on the worker thread surfaces at the NEXT get(),
    not when the caller reaches the failed round."""
    def build(r):
        if r == 1:
            raise RuntimeError("boom round 1")
        return f"cohort-{r}"

    s = AsyncCohortStager(build, enabled=True)
    try:
        assert s.get(0, prefetch=1) == "cohort-0"   # round 1 builds async
        _wait_for(lambda: s._failed is not None)
        with pytest.raises(RuntimeError, match="boom round 1"):
            s.get(2, prefetch=3)
        assert s.get(2) == "cohort-2"               # delivered once
        assert s.stats()["worker_restarts"] == 1
    finally:
        s.close()


def test_stager_delivers_failure_at_its_own_round_once():
    def build(r):
        if r == 1:
            raise RuntimeError("boom")
        return r

    s = AsyncCohortStager(build, enabled=True)
    try:
        assert s.get(0, prefetch=1) == 0
        with pytest.raises(RuntimeError, match="boom"):
            s.get(1, prefetch=2)
        assert s.get(2) == 2
        assert s.get(3) == 3
    finally:
        s.close()


def test_stager_drops_stale_pending_futures():
    s = AsyncCohortStager(lambda r: r, enabled=True)
    try:
        s.get(0, prefetch=1)
        _wait_for(lambda: 1 in s._pending and s._pending[1].done())
        assert s.get(5, prefetch=6) == 5
        assert 1 not in s._pending
    finally:
        s.close()


def test_stager_close_is_idempotent_and_degrades_to_sync():
    s = AsyncCohortStager(lambda r: r * 10, enabled=True)
    s.get(0, prefetch=1)
    s.close()
    s.close()
    assert s.get(7, prefetch=8) == 70
    assert 8 not in s._pending


def test_stager_disabled_builds_synchronously():
    s = AsyncCohortStager(lambda r: -r, enabled=False)
    assert s.get(3, prefetch=4) == -3
    assert not s._pending
    s.close()
    s.close()


def test_stager_prefetches_blocks_at_their_stride():
    """A fused loop's stager keys builds by block start: ``depth``
    blocks ahead at ``stride``, never past ``limit``; a prefetched block
    is a hit."""
    built = []

    def build(r):
        built.append(r)
        return r

    s = AsyncCohortStager(build, enabled=True, depth=2, stride=4, limit=10)
    try:
        assert s.get(0, prefetch=4) == 0
        _wait_for(lambda: sorted(built) == [0, 4, 8])
        assert s.get(4, prefetch=8) == 4
        assert s.stats()["hits"] == 1 and s.stats()["misses"] == 1
        assert sorted(built) == [0, 4, 8]
    finally:
        s.close()


# -- cohort bucketing --------------------------------------------------------

def bucket_cfg(optimizer, **over):
    """``test_cohort_bucketing_matches_unbucketed``'s skewed split."""
    cfg = dict(dataset="synthetic", num_classes=4, input_shape=(10,),
               train_size=1200, test_size=120, model="lr",
               client_num_in_total=24, client_num_per_round=12, comm_round=4,
               epochs=1, batch_size=8, learning_rate=0.2,
               federated_optimizer=optimizer, partition_method="hetero",
               partition_alpha=0.15, frequency_of_the_test=100,
               random_seed=5, data_cache_dir="")
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("optimizer,over", [
    ("FedAvg", {}), ("FedProx", {}), ("FedOpt", {}),
    ("FedOpt", dict(server_lr=0.03))],
    ids=["FedAvg", "FedProx", "FedOpt", "FedOpt-lr0.03"])
def test_cohort_bucketing_matches_unbucketed(optimizer, over):
    """Bucketed rounds (pow2 step classes, one partial program each,
    exact merge; the device-gather path) do the same real work over
    strictly fewer allocated step slots, and end within the JAX test's
    bars of the unbucketed rounds.  Against the JAX package's bucketed
    rounds (host batches) within 1e-5 after every round, except FedOpt's
    server Adam at its default server_lr 1.0 (see the module docstring),
    which holds only the within-port bars."""
    japi, buck, model = build(bucket_cfg(optimizer, cohort_bucketing=True,
                                         device_data=False, **over),
                              JFedAvgAPI, TFedAvgAPI)
    buck = twin(buck, device_data=True)
    buck.state = buck.state.replace(
        global_params=port_tree(japi.state.global_params, model))
    plain = twin(buck, cohort_bucketing=False)
    vs_jax = optimizer != "FedOpt" or "server_lr" in over
    for r in range(4):
        m_plain = plain.train_one_round(r)
        m_buck = buck.train_one_round(r)
        assert float(m_buck["total_steps"]) == float(m_plain["total_steps"])
        assert m_buck["allocated_steps"] < m_plain["allocated_steps"], r
        m_j = japi.train_one_round(r)
        assert m_buck["allocated_steps"] == int(m_j["allocated_steps"])
        assert float(m_buck["total_steps"]) == float(m_j["total_steps"])
        if vs_jax:
            assert abs(float(m_buck["train_loss"]) -
                       float(m_j["train_loss"])) < TOL
            state_close(japi, buck, model)
    l0, a0 = plain.evaluate()
    l1, a1 = buck.evaluate()
    assert abs(l0 - l1) < 2e-4, (optimizer, l0, l1)
    assert abs(a0 - a1) < 2e-2, (optimizer, a0, a1)


def test_cohort_bucketing_with_dropout_and_host_batches():
    """The CNN with dropout: the cohort's masks are drawn once and sliced
    per bucket, so bucketed rounds end within the bars of the unbucketed
    ones; the host-batch path (``device_data=False``) gives the
    device-gather path's rounds."""
    cfg = t_arguments().update(**bucket_cfg(
        "FedAvg", model="cnn", input_shape=(14, 14, 1), num_classes=10,
        train_size=480, test_size=96, comm_round=2, learning_rate=0.1,
        cohort_bucketing=True))
    buck = port(TFedAvgAPI, cfg)
    plain = twin(buck, cohort_bucketing=False)
    host = twin(buck, device_data=False)
    for r in range(2):
        m_plain, m_buck = plain.train_one_round(r), buck.train_one_round(r)
        m_host = host.train_one_round(r)
        assert float(m_buck["total_steps"]) == float(m_plain["total_steps"])
        assert m_buck["allocated_steps"] < m_plain["allocated_steps"]
        assert float(m_host["train_loss"]) == float(m_buck["train_loss"])
    (l0, a0), (l1, a1) = plain.evaluate(), buck.evaluate()
    assert abs(l0 - l1) < 2e-4 and abs(a0 - a1) < 2e-2, (l0, l1, a0, a1)
    for k, v in buck.state.global_params.items():
        assert torch.equal(v, host.state.global_params[k]), k


@pytest.mark.parametrize("optimizer", ["SCAFFOLD", "FedDyn", "FedNova",
                                       "Mime"])
def test_cohort_bucketing_refuses_stateful_algorithms(optimizer):
    """Algorithms whose aggregates do not merge across buckets refuse the
    flag by name, as the JAX package's do."""
    cfg = bucket_cfg(optimizer, cohort_bucketing=True)
    with pytest.raises(ValueError, match="cohort_bucketing"):
        port(TFedAvgAPI, t_arguments().update(**cfg))
    with pytest.raises(ValueError, match="cohort_bucketing"):
        build(cfg, JFedAvgAPI, TFedAvgAPI)
