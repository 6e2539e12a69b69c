"""The port's hierarchical, async and decentralized sp engines against the
JAX package's, on the CPU, and the topology manager's copy.

Each case starts both engines from the same weights (the JAX init carried
across by ``models/convert.py``) on the same data, so the cohorts, groups,
batch schedules, latencies and masks are bitwise the same and the rounds
differ only by f32 rounding.  Tolerance: params (every client's, for the
decentralized engine) and the round loss within 1e-5 (absolute) after each
round; ``evaluate()`` too at the end.  The topology manager is a numpy
copy, pinned bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.core.distributed.topology import topology_manager as j_topo
from fedml_tpu.simulation.sp.async_fedavg import AsyncFedAvgAPI as JAsync
from fedml_tpu.simulation.sp.decentralized import \
    DecentralizedFedAPI as JDecentralized
from fedml_tpu.simulation.sp.hierarchical_fl import \
    HierarchicalFedAvgAPI as JHierarchical

import fedml_tpu_torch
from fedml_tpu_torch.core.distributed.topology import \
    topology_manager as t_topo
from fedml_tpu_torch.simulation.sp.async_fedavg import \
    AsyncFedAvgAPI as TAsync
from fedml_tpu_torch.simulation.sp.decentralized import \
    DecentralizedFedAPI as TDecentralized
from fedml_tpu_torch.simulation.sp.hierarchical_fl import \
    HierarchicalFedAvgAPI as THierarchical

from .torch_sp_parity import (TOL, base_args, build, port, port_tree, tiny,
                              tree_close)


@pytest.mark.parametrize("cls", ["SymmetricTopologyManager",
                                 "AsymmetricTopologyManager"])
@pytest.mark.parametrize("n,nbrs", [(2, 2), (5, 1), (5, 2), (8, 3), (13, 4),
                                    (16, 6)])
def test_topology_copy_matches_jax_bitwise(cls, n, nbrs):
    got = getattr(t_topo, cls)(n, nbrs)
    ref = getattr(j_topo, cls)(n, nbrs)
    assert got.mixing_matrix().dtype == ref.mixing_matrix().dtype
    assert np.array_equal(got.mixing_matrix(), ref.mixing_matrix())
    for i in range(n):
        assert got.get_in_neighbor_idx_list(i) == \
            ref.get_in_neighbor_idx_list(i)
        assert got.get_out_neighbor_idx_list(i) == \
            ref.get_out_neighbor_idx_list(i)


def _start_same(japi, tapi, model):
    tapi.state = tapi.state.replace(
        global_params=port_tree(japi.state.global_params, model))


def test_hierarchical_rounds_match_jax():
    """Three groups, two inner rounds a global round, on the ragged
    split."""
    japi, tapi, model = build(
        tiny(federated_optimizer="HierarchicalFL", group_num=3,
             group_comm_round=2, client_num_per_round=6), JHierarchical,
        THierarchical)
    _start_same(japi, tapi, model)
    for r in range(2):
        jm = japi.train_one_round(r)
        tm = tapi.train_one_round(r)
        assert abs(float(tm["train_loss"]) - float(jm["train_loss"])) < TOL
        tree_close(tapi.state.global_params, japi.state.global_params,
                   model, f"round {r}")
        assert tapi.state.round_idx == int(japi.state.round_idx) == r + 1
    jl, ja = japi.evaluate()
    tl, ta = tapi.evaluate()
    assert abs(tl - jl) < TOL and abs(ta - ja) < TOL


def test_async_rounds_match_jax():
    """Latencies up to 3 ticks: updates merge out of dispatch order with
    staleness-discounted weights; ``async_alpha`` comes from the args
    (0.5)."""
    japi, tapi, model = build(
        tiny(federated_optimizer="async_fedavg", async_max_latency=3,
             comm_round=5), JAsync, TAsync)
    assert tapi.mix_alpha == japi.mix_alpha == 0.5
    _start_same(japi, tapi, model)
    merged = []
    for r in range(5):
        jm = japi.train_one_round(r)
        tm = tapi.train_one_round(r)
        assert tm["merged"] == jm["merged"]
        merged.append(tm["merged"])
        assert abs(float(tm["train_loss"]) - float(jm["train_loss"])) < TOL
        tree_close(tapi.state.global_params, japi.state.global_params,
                   model, f"tick {r}")
    assert tapi._version == japi._version == sum(merged)
    assert len(tapi._pending) == len(japi._pending) > 0
    jl, ja = japi.evaluate()
    tl, ta = tapi.evaluate()
    assert abs(tl - jl) < TOL and abs(ta - ja) < TOL


@pytest.mark.parametrize("topo", ["symmetric", "asymmetric"])
def test_decentralized_rounds_match_jax(topo):
    japi, tapi, model = build(
        tiny(federated_optimizer="dsgd", topology=topo,
             topology_neighbors=2), JDecentralized, TDecentralized)
    start = jax.tree_util.tree_map(lambda l: l[0], japi.params)
    tapi.params = {k: torch.stack([v] * tapi.n)
                   for k, v in port_tree(start, model).items()}
    assert torch.equal(tapi.W, torch.tensor(np.array(japi.W)))
    for r in range(3):
        jm = japi.train_one_round(r)
        tm = tapi.train_one_round(r)
        assert abs(float(tm["train_loss"]) - float(jm["train_loss"])) < TOL
        for i in range(tapi.n):
            tree_close({k: v[i] for k, v in tapi.params.items()},
                       jax.tree_util.tree_map(lambda l: l[i], japi.params),
                       model, f"round {r} client {i}")
        np.testing.assert_allclose(tapi.omega.numpy(),
                                   np.asarray(japi.omega), rtol=0, atol=TOL)
    tree_close(tapi.consensus_params(), japi.consensus_params(), model,
               "consensus")
    jl, ja = japi.evaluate()
    tl, ta = tapi.evaluate()
    assert abs(tl - jl) < TOL and abs(ta - ja) < TOL


# -- the engine learning tests of tests/test_algorithms.py, mirrored --------

def test_hierarchical_fl_learns():
    api = port(THierarchical, base_args(group_num=3, group_comm_round=2,
                                         comm_round=3))
    _, acc0 = api.evaluate()
    api.train()
    _, acc1 = api.evaluate()
    assert acc1 > max(acc0, 0.3)


def test_async_fedavg_learns():
    api = port(TAsync, base_args(comm_round=10, async_alpha=0.5,
                                  async_max_latency=3))
    _, acc0 = api.evaluate()
    api.train()
    _, acc1 = api.evaluate()
    assert acc1 > max(acc0, 0.3)
    assert api._version > 0


@pytest.mark.parametrize("topo", ["symmetric", "asymmetric"])
def test_decentralized_dsgd_learns(topo):
    args = base_args(client_num_in_total=8, comm_round=6, topology=topo,
                     topology_neighbors=2)
    api = port(TDecentralized, args)
    _, acc0 = api.evaluate()
    api.train()
    _, acc1 = api.evaluate()
    assert acc1 > max(acc0, 0.3), (topo, acc0, acc1)


@pytest.mark.parametrize("name,cls", [("HierarchicalFL", THierarchical),
                                      ("async_fedavg", TAsync),
                                      ("fedasync", TAsync),
                                      ("dsgd", TDecentralized),
                                      ("push_sum", TDecentralized)])
def test_run_simulation_dispatches_engines(name, cls, monkeypatch):
    """Mirrors ``test_run_simulation_dispatches_algorithms``: the
    simulator picks the engine ``federated_optimizer`` names, and
    ``run_simulation`` returns its params."""
    built = []
    init = cls.__init__

    def spy(self, *a, **kw):
        built.append(type(self))
        init(self, *a, **kw)

    monkeypatch.setattr(cls, "__init__", spy)
    args = base_args(federated_optimizer=name, comm_round=2, group_num=2,
                     group_comm_round=1, client_num_in_total=6)
    params = fedml_tpu_torch.run_simulation(backend="sp", args=args,
                                            device="cpu")
    assert built == [cls]
    assert all(torch.isfinite(v).all() for v in params.values())


@pytest.mark.parametrize("cls", [THierarchical, TAsync, TDecentralized])
def test_engines_refuse_other_algorithms(cls):
    """The engines run FedAvg rounds; asked for another algorithm of the
    zoo they raise naming it instead of running FedAvg."""
    args = base_args(federated_optimizer="SCAFFOLD")
    with pytest.raises(NotImplementedError, match="scaffold"):
        port(cls, args)


@pytest.mark.parametrize("cls", [THierarchical, TAsync, TDecentralized])
def test_engines_run_on_the_card_unless_asked(cls, monkeypatch):
    """No fallback: without CUDA an engine built with no device raises;
    ``"cpu"`` is only taken when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = base_args()
    ds, out = fedml_tpu_torch.data.load(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(args, None, ds, fedml_tpu_torch.model.create(args, out))
    assert port(cls, args).trainer is not None
