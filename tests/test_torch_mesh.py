"""The port's mesh engine on 2 gloo ranks against the JAX package's mesh
engine on 2 of the virtual CPU devices, on the CPU.

Both start from the JAX engine's weights (carried across by
``models/convert.py``), sample the same cohorts and batches (the host
streams are bitwise the same) and differ only by the order of f32 sums.
Limits: the JAX tests' own for mesh parity (``tests/test_update_sharding.
py``: atol 2e-5, rtol 1e-4) on the losses, the params, every server-state
field in its layout (the scatter layout's flat vectors against the JAX
engine's, element for element: the port flattens in the JAX layout) and
every row of the per-client table.  The port's mesh against the port's
sp engine from the same weights: 1e-6.

The ranks run in processes spawned by
``fedml_tpu_torch.simulation.mesh.launch.spawn``; their bodies are in
``tests/torch_mesh_ranks.py`` (no JAX there).  One spawn runs every case
of the file (``_port_runs``), so the file pays for the ranks' start once.
"""

import types

import numpy as np
import pytest
import torch

from fedml_tpu_torch.core import mesh as t_mesh
from fedml_tpu_torch.simulation.mesh.launch import spawn
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvg

from .torch_mesh_parity import (SPAWN_TIMEOUT, STATEFUL_ALGS, close,
                                jax_mesh, mesh_cfg, port_model, state_close,
                                to_port)
from .torch_mesh_ranks import _build, to_np

N = 2
LAYOUTS = ("replicated", "scatter")
CASES = [(alg, lay) for alg in STATEFUL_ALGS for lay in LAYOUTS]
#: 3 clients a round on 2 ranks: one zero-weight pad row
PADDED = [("SCAFFOLD", lay) for lay in LAYOUTS]
#: the dataset rows split over the ranks, and cohorts staged on the host
DATA_MODES = ["sharded", "host"]

_RUNS = {}


def _port_runs():
    """Every case's JAX run (in this process) and the port's (one spawn
    of 2 ranks), keyed by case."""
    if _RUNS:
        return _RUNS
    model = port_model(mesh_cfg())
    jobs, keys = [], []

    def add(key, cfg, jax_cfg=None):
        japi, init, ms = jax_mesh(jax_cfg or cfg, N, 3)
        _RUNS[key] = dict(japi=japi, jms=ms, cfg=cfg,
                          init=to_port(init, model))
        jobs.append((cfg, 3, _RUNS[key]["init"], None))
        keys.append(key)

    for alg, lay in CASES:
        add((alg, lay), mesh_cfg(federated_optimizer=alg,
                                 update_sharding=lay))
    for alg, lay in PADDED:
        add(("padded", alg, lay), mesh_cfg(federated_optimizer=alg,
                                           update_sharding=lay,
                                           client_num_per_round=3))
    for mode in DATA_MODES:
        # the JAX engine's replicated-data run is the reference: its test
        # holds every device_data mode to the same curve
        cfg = mesh_cfg(federated_optimizer="SCAFFOLD",
                       update_sharding="scatter", device_data=mode)
        add(("data", mode), cfg,
            mesh_cfg(federated_optimizer="SCAFFOLD",
                     update_sharding="scatter"))
    res = spawn("tests.torch_mesh_ranks:mesh_cases", N, (jobs,),
                timeout=SPAWN_TIMEOUT)[0]
    for key, r in zip(keys, res):
        _RUNS[key]["port"] = r
    _RUNS["model"] = model
    return _RUNS


def _check(key, what):
    run = _port_runs()[key]
    res = run["port"]
    assert res["shards"] == N
    close(res["losses"], [m[0] for m in run["jms"]], f"{what} losses")
    assert res["steps"] == [m[1] for m in run["jms"]], what
    state_close(res, run["japi"], _RUNS["model"], what)
    return run


@pytest.mark.parametrize("alg,layout", CASES)
def test_mesh_matches_jax_mesh_on_2_ranks(alg, layout):
    run = _check((alg, layout), f"{alg}/{layout}")
    assert run["port"]["layout"] == layout
    assert run["port"]["precision"] == "fp32"


@pytest.mark.parametrize("alg,layout", PADDED)
def test_padded_cohort_counts_only_real_clients(alg, layout):
    """3 clients on 2 ranks: the pad row has zero weight, the sentinel
    id, every step masked; SCAFFOLD's |S|/N counts the 3 real clients."""
    run = _check(("padded", alg, layout), f"padded {alg}/{layout}")
    assert run["japi"].n_shards == N


@pytest.mark.parametrize("mode", DATA_MODES)
def test_device_data_modes_match_the_replicated_dataset(mode):
    _check(("data", mode), f"device_data={mode}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_matches_port_sp_engine(layout):
    """The port's 2-rank mesh against the port's sp engine from the same
    weights: FedAvg's params and losses within 1e-6."""
    run = _port_runs()[("FedAvg", layout)]
    sp = _build(TFedAvg, run["cfg"])
    sp.reset_params({k: torch.as_tensor(v) for k, v in run["init"].items()})
    losses = [float(sp.train_one_round(r)["train_loss"]) for r in range(3)]
    close(run["port"]["losses"], losses, "losses", atol=1e-6, rtol=0)
    for k, v in sp.state.global_params.items():
        close(run["port"]["state"]["global_params"][k], v.numpy(), k,
              atol=1e-6, rtol=0)


def test_run_simulation_mesh_backends_on_2_ranks():
    """``run_simulation``'s path (``FedMLRunner`` → ``SimulatorMesh``) for
    each backend name on 2 ranks ends where the sp engine ends (1e-6), one
    record a round; decentralized SGD goes to the ring engine."""
    cfgs = [dict(mesh_cfg(comm_round=2), backend=b)
            for b in ("mesh", "MPI", "NCCL")]
    ring = dict(mesh_cfg(comm_round=2, federated_optimizer="dsgd",
                         client_num_in_total=8), backend="mesh")
    res = spawn("tests.torch_mesh_ranks:mesh_train", N, (cfgs + [ring],),
                timeout=SPAWN_TIMEOUT)[0]
    sp = _build(TFedAvg, mesh_cfg(comm_round=2))
    sp.train()
    for r in res[:3]:
        assert r["type"] == "MeshFedAvgAPI"
        assert len(r["losses"]) == 2
        for k, v in sp.state.global_params.items():
            close(r["params"][k], v.numpy(), k, atol=1e-6, rtol=0)
    assert res[3]["type"] == "MeshDecentralizedAPI"


@pytest.mark.parametrize("over,what", [
    (dict(mesh_shape="2,2,2", mesh_data=2), "mesh_data"),
    (dict(mesh_shape="2,2", mesh_data=2), "mesh_data"),
    (dict(mesh_data=2), "mesh_data"),
    (dict(mesh_shape="1,2,2", mesh_seq=2), "mesh_seq"),
    (dict(mesh_seq=2), "mesh_seq")])
def test_unported_mesh_factors_raise_by_name(over, what):
    """The factors the simulation engine does not run raise before any
    process group is made, naming themselves and the backend, whatever
    the layout (the 2-D and 3-D layouts run since their slices:
    ``tests/test_torch_mesh2d.py``, ``tests/test_torch_pipeline.py``; a
    seq group serves ring attention in the causal LM); ``make_mesh``
    refuses a data factor."""
    from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI
    cfg = dict(mesh_cfg(**over), backend="NCCL")
    with pytest.raises(NotImplementedError, match=what) as err:
        _build(MeshFedAvgAPI, cfg)
    assert "NCCL" in str(err.value)
    with pytest.raises(NotImplementedError, match="data"):
        t_mesh.make_mesh(data=2, device="cpu")


def test_unported_mesh_regimes_raise_by_name():
    """Still refused by name: another axis than client and model in
    ``FedLLMAPI(mesh=...)``, the streaming loss over a row-parallel
    ``lm_head``, a model factor that does not divide the MoE experts,
    push-sum on the ring (the model factor itself runs since its slice:
    ``tests/test_torch_tp.py``)."""
    from fedml_tpu_torch.arguments import load_arguments
    from fedml_tpu_torch.llm.fedllm import FedLLMAPI
    from fedml_tpu_torch.llm.moe import MoEMLP
    from fedml_tpu_torch.simulation.mesh.decentralized_mesh import \
        MeshDecentralizedAPI
    mesh = t_mesh.Mesh(1, 0, "cpu")
    mesh.shape["stage"] = 2
    with pytest.raises(NotImplementedError, match="client x model"):
        FedLLMAPI(load_arguments(), None, mesh=mesh)
    args = load_arguments().update(streaming_xent_chunk=64)
    ds = types.SimpleNamespace(num_classes=256)
    with pytest.raises(NotImplementedError, match="streaming_xent_chunk"):
        FedLLMAPI(args, ds, mesh=t_mesh.Mesh(2, 0, "cpu", model=2))
    with pytest.raises(NotImplementedError, match="mesh"):
        MoEMLP(8, 16, 2, mesh=t_mesh.Mesh(3, 0, "cpu", model=3))
    with pytest.raises(ValueError, match="ring"):
        _build(MeshDecentralizedAPI, mesh_cfg(federated_optimizer="push_sum",
                                              topology="asymmetric"))


def test_launch_reports_a_failing_rank_and_a_hang():
    """A rank that raises fails the spawn with its traceback; a rank that
    never returns fails it at the timeout, and no process is left.  The
    timeout leaves rank 0 room to start and return on a loaded host (6
    test workers: over 15 s)."""
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        spawn("tests.torch_mesh_ranks:fail_on_rank_1", 2, timeout=60)
    with pytest.raises(TimeoutError, match="ranks \\[1\\]"):
        spawn("tests.torch_mesh_ranks:hang_on_rank_1", 2, timeout=45)


def test_layout_pads_and_slices_rows():
    from fedml_tpu_torch.simulation.mesh.layout import MeshLayout
    layout = MeshLayout(t_mesh.Mesh(4, 2, "cpu"))
    assert layout.pad_rows(5) == 8 and layout.pad_rows(8) == 8
    assert layout.local_rows(8) == slice(4, 6)
    assert t_mesh.pad_to_multiple(5, 4) == 8
    assert t_mesh.parse_mesh_shape("4x2") == (4, 2)
    assert t_mesh.parse_mesh_shape(None) is None
    np.testing.assert_array_equal(
        to_np(torch.arange(3)), np.arange(3))


@pytest.mark.parametrize("alg", STATEFUL_ALGS + ["FedSGD", "qfedavg"])
def test_update_shard_is_the_replicated_transition(alg):
    """The scatter layout's ``update_shard`` on one shard (the whole flat
    model) ≡ ``update_from_aggregates`` on the params dict, flattened:
    params and every aux field, over two rounds carrying the state."""
    from fedml_tpu_torch.core.flatmodel import FlatSpec
    from fedml_tpu_torch.ml.aggregator.agg_operator import ServerOptimizer
    from fedml_tpu_torch.arguments import load_arguments
    rng = np.random.default_rng(3)
    params = {"w": torch.tensor(rng.normal(size=(5, 3)), dtype=torch.float32),
              "b": torch.tensor(rng.normal(size=(3,)), dtype=torch.float32)}
    flat = FlatSpec.of(params)
    opt = ServerOptimizer(load_arguments().update(
        federated_optimizer=alg, client_num_in_total=10, server_lr=0.5))
    rep = opt.init(params)
    sh = opt.init_sharded(params, 1, flat)
    gflat = flat.flatten(params)
    for _ in range(2):
        def stacked():
            return {k: torch.tensor(rng.normal(size=(4,) + tuple(v.shape)),
                                    dtype=torch.float32)
                    for k, v in params.items()}
        aux = {"delta_c": stacked(), "grad_sum": stacked(),
               "tau": torch.tensor([3.0, 5.0, 2.0, 4.0]),
               "loss": torch.tensor(rng.uniform(1, 2, size=4),
                                    dtype=torch.float32)}
        w = torch.tensor([1.0, 2.0, 0.5, 1.5])
        agg = opt.compute_aggregates(rep, stacked(), w, aux)
        rep = opt.update_from_aggregates(rep, agg)
        flat_agg = {k: flat.flatten(v) if isinstance(v, dict) else v
                    for k, v in agg.items()}
        gflat, fields = opt.update_shard(sh, gflat, flat_agg)
        sh = sh.replace(**fields)
        np.testing.assert_allclose(gflat, flat.flatten(rep.global_params),
                                   rtol=1e-6, atol=1e-7)
        for f in ("c_server", "h", "momentum"):
            if getattr(rep, f) is not None:
                np.testing.assert_allclose(getattr(sh, f),
                                           flat.flatten(getattr(rep, f)),
                                           rtol=1e-6, atol=1e-7)


def test_shutdown_world_tears_down_the_group():
    """``shutdown_world`` ends the process group (a world of 1 over gloo
    here) and does nothing without one; ``make_mesh`` makes it anew."""
    import torch.distributed as dist
    from fedml_tpu_torch.simulation.round_engine import BlockRoundFn
    t_mesh.make_mesh(client=1, device="cpu")
    assert dist.is_initialized()
    t_mesh.shutdown_world()
    assert not dist.is_initialized()
    t_mesh.shutdown_world()
    assert t_mesh.make_mesh(client=1, device="cpu").size == 1
    fn = BlockRoundFn(None, None, False)
    fn._slots, fn._static = {"k": object()}, object()
    fn.release()
    assert fn._slots == {} and fn._static is None and fn._pool is None
