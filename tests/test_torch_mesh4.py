"""The port's mesh engines on 4 gloo ranks, on the CPU: ``MeshFedAvgAPI``
against the JAX package's mesh engine on 4 of the virtual CPU devices
(every stateful algorithm, both merge layouts, and a padded cohort of 5
clients on 4 ranks), the hierarchical mesh against the JAX one, and the
ring gossip against the sp engine's dense einsum
(``tests/test_mesh.py::test_mesh_decentralized_ring_matches_sp_einsum``'s
reference, the JAX ``DecentralizedFedAPI``).

Both packages start from the JAX engine's weights.  Limits: the JAX
tests' own for mesh parity (atol 2e-5, rtol 1e-4) on losses, params,
every server-state field and every table row; the hierarchical and ring
engines' params to the same limits, their evaluations as the JAX tests
hold them (loss 1e-4, accuracy 1e-6).  One spawn of 4 ranks runs every
case of the file."""

import jax
import numpy as np
import pytest

from fedml_tpu.core.mesh import make_mesh as j_make_mesh
from fedml_tpu.simulation.mesh.hierarchical_mesh import \
    MeshHierarchicalAPI as JHier
from fedml_tpu.simulation.sp.decentralized import \
    DecentralizedFedAPI as JDecentralized
from jax.sharding import Mesh as JMesh

from fedml_tpu_torch.simulation.mesh.launch import spawn

from .torch_mesh_parity import (SPAWN_TIMEOUT, STATEFUL_ALGS, close,
                                jax_api, jax_mesh, mesh_cfg, port_model,
                                state_close, to_port)

N = 4
LAYOUTS = ("replicated", "scatter")
CASES = [(alg, lay) for alg in STATEFUL_ALGS for lay in LAYOUTS]
#: 5 clients a round on 4 ranks: three zero-weight pad rows
PADDED = [("FedDyn", lay) for lay in LAYOUTS]


def hier_cfg(**over):
    """``tests/test_mesh.py::test_mesh_hierarchical_matches_sp``'s config:
    16 clients in 4 groups, 2 inner rounds; 5 of 16 can empty a group."""
    cfg = dict(dataset="synthetic", num_classes=4, input_shape=(10,),
               train_size=640, test_size=96, model="lr",
               client_num_in_total=16, client_num_per_round=12,
               comm_round=3, epochs=1, batch_size=8, learning_rate=0.2,
               group_num=4, group_comm_round=2, partition_method="hetero",
               partition_alpha=0.4, frequency_of_the_test=100, random_seed=7,
               device_data=False, data_cache_dir="")
    cfg.update(over)
    return cfg


def ring_cfg(n):
    """``test_mesh_decentralized_ring_matches_sp_einsum``'s config."""
    return dict(dataset="synthetic", num_classes=4, input_shape=(10,),
                train_size=320, test_size=64, model="lr",
                client_num_in_total=n, comm_round=3, epochs=1, batch_size=8,
                learning_rate=0.2, topology="symmetric",
                topology_neighbors=2, partition_method="homo",
                random_seed=3, data_cache_dir="")


HIER = [{}, {"client_num_per_round": 5}]
RINGS = [8, 16]        # 2 and 4 clients a rank
_RUNS = {}


def _runs():
    if _RUNS:
        return _RUNS
    model = port_model(mesh_cfg())
    jobs, keys = [], []
    for key, cfg in ([((a, l), mesh_cfg(federated_optimizer=a,
                                        update_sharding=l))
                      for a, l in CASES]
                     + [(("padded", a, l), mesh_cfg(
                         federated_optimizer=a, update_sharding=l,
                         client_num_per_round=5)) for a, l in PADDED]):
        japi, init, ms = jax_mesh(cfg, N, 3)
        _RUNS[key] = dict(japi=japi, jms=ms, init=to_port(init, model))
        jobs.append((cfg, 3, _RUNS[key]["init"], None))
        keys.append(key)
    calls = [("tests.torch_mesh_ranks:mesh_cases", (jobs,))]

    small = port_model(hier_cfg())
    for i, over in enumerate(HIER):
        japi = jax_api(JHier, hier_cfg(**over), mesh=JMesh(
            np.array(jax.devices()[:N]), ("group",)))
        init = to_port(japi.state.global_params, small)
        for r in range(3):
            japi.train_one_round(r)
        _RUNS[("hier", i)] = dict(japi=japi, init=init)
        calls.append(("tests.torch_mesh_ranks:hierarchical",
                      (hier_cfg(**over), 3, init)))
    for n in RINGS:
        japi = jax_api(JDecentralized, ring_cfg(n))
        ring_model = port_model(ring_cfg(n))
        init = to_port(jax.tree_util.tree_map(lambda l: np.asarray(l)[0],
                                              japi.params), ring_model)
        for r in range(3):
            japi.train_one_round(r)
        _RUNS[("ring", n)] = dict(japi=japi, model=ring_model)
        calls.append(("tests.torch_mesh_ranks:ring", (ring_cfg(n), 3, init)))
    res = spawn("tests.torch_mesh_ranks:several", N, (calls,),
                timeout=SPAWN_TIMEOUT)[0]
    for key, r in zip(keys, res[0]):
        _RUNS[key]["port"] = r
    for i, r in enumerate(res[1:1 + len(HIER)]):
        _RUNS[("hier", i)]["port"] = r
    for n, r in zip(RINGS, res[1 + len(HIER):]):
        _RUNS[("ring", n)]["port"] = r
    _RUNS["model"], _RUNS["small"] = model, small
    return _RUNS


def _check(key, what):
    run = _runs()[key]
    res = run["port"]
    assert res["shards"] == N
    close(res["losses"], [m[0] for m in run["jms"]], f"{what} losses")
    assert res["steps"] == [m[1] for m in run["jms"]], what
    state_close(res, run["japi"], _RUNS["model"], what)
    return res


@pytest.mark.parametrize("alg,layout", CASES)
def test_mesh_matches_jax_mesh_on_4_ranks(alg, layout):
    assert _check((alg, layout), f"{alg}/{layout}")["layout"] == layout


@pytest.mark.parametrize("alg,layout", PADDED)
def test_padded_cohort_of_5_on_4_ranks(alg, layout):
    _check(("padded", alg, layout), f"padded {alg}/{layout}")


@pytest.mark.parametrize("case", range(len(HIER)))
def test_hierarchical_mesh_matches_jax(case):
    """One group a rank, one all-reduce a global round, against the JAX
    hierarchical mesh on a 4-device ``group`` axis (its second case can
    leave a group empty)."""
    run = _runs()[("hier", case)]
    japi, res = run["japi"], run["port"]
    for k, v in to_port(japi.state.global_params, _RUNS["small"]).items():
        close(res["params"][k], v, k)
    j_loss, j_acc = japi.evaluate()
    p_loss, p_acc = res["eval"]
    assert np.isfinite(p_loss)
    assert abs(p_loss - j_loss) < 1e-4 and abs(p_acc - j_acc) < 1e-6


@pytest.mark.parametrize("n", RINGS)
def test_ring_gossip_matches_the_einsum_reference(n):
    """Every client's params after 3 rounds of ring DSGD (ghost rows by
    send/recv) against the JAX sp engine's dense ``x ← W x``."""
    run = _runs()[("ring", n)]
    japi, res = run["japi"], run["port"]
    for i in range(n):
        ref = to_port(jax.tree_util.tree_map(lambda l: np.asarray(l)[i],
                                             japi.params), run["model"])
        for k, v in ref.items():
            close(res["params"][k][i], v, f"client {i} {k}")
    j_loss, j_acc = japi.evaluate()
    p_loss, p_acc = res["eval"]
    assert abs(p_loss - j_loss) < 1e-4 and abs(p_acc - j_acc) < 1e-6
