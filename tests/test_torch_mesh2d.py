"""The port's 2-D ``client × model`` mesh on 4 gloo ranks (2 × 2 and
1 × 4), on the CPU: ``MeshFedAvgAPI`` with ``mesh_shape="c,m"`` against
the JAX package's sp engine (the JAX tests hold the 2-D layout to it:
``tests/test_mesh2d.py::test_parity_sp_1d_2d``; the JAX 2-D engine itself
needs ``shard_map(auto=...)``, which this image's jax refuses).

Both start from the JAX sp engine's weights.  Limits: the JAX test's own
(atol 2e-5, rtol 1e-4) on the losses, the whole params and every table
row, for FedAvg, FedOpt (``server_lr`` 0.03), SCAFFOLD, FedDyn and Mime
under both merge layouts on ``lr``; on a conv net (SCAFFOLD, both
layouts) the losses and params to the same limits, the table rows within
twice the port's sp engine's own distance from the JAX one (the control
variates amplify the f32 order of the sums).  The quantized merges (bf16, int8 with error
feedback) are held to the fp32 run within the JAX package's quantized
limits (bf16 2e-3, int8 1e-2: ``tests/test_collective_precision.py``).
Also pinned: each rank rests on ``1/(c·m)`` of the padded flat state and
``1/m`` of every sharded matrix; the port's ``param_spec`` is the JAX
``MeshLayout.param_spec``; ``round_block`` on 2-D is bitwise the unfused
rounds; a checkpoint round trip resumes bitwise; ``make_mesh2d``'s forms;
and the refusals that stay, by name (the 3-D layout, ring attention and
the mesh's client-state plane run since their slice:
``tests/test_torch_{pipeline,ring,mesh_state}.py``).  One spawn of 4 ranks runs every
multi-rank case of the file."""

import types

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.core.mesh import make_mesh2d as j_make_mesh2d
from fedml_tpu.core.mesh import parse_mesh_shape as j_parse
from fedml_tpu.simulation.mesh.layout import MeshLayout as JLayout
from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvg

from fedml_tpu_torch.core import mesh as t_mesh
from fedml_tpu_torch.simulation.mesh.launch import spawn
from fedml_tpu_torch.simulation.mesh.layout import MeshLayout

from .torch_mesh_parity import (SPAWN_TIMEOUT, close, jax_api, mesh_cfg,
                                port_model, to_port)
from .torch_mesh_ranks import _build

N = 4
ALGS = ["FedAvg", "FedOpt", "SCAFFOLD", "FedDyn", "Mime"]
LAYOUTS = ("replicated", "scatter")
CASES = [(alg, lay, "2,2") for alg in ALGS for lay in LAYOUTS] + \
    [(alg, lay, "1,4") for alg in ("FedOpt", "SCAFFOLD") for lay in LAYOUTS]
#: a conv net without dropout (the port's dropout masks are torch's
#: draws): its kernels shard in flax's HWIO layout, kept in the port's OIHW
CNN = dict(model="cnn_cifar", input_shape=(32, 32, 3), train_size=256,
           test_size=64, client_num_per_round=6, batch_size=16)
CNN_CASES = [("SCAFFOLD", "scatter", "2,2"), ("SCAFFOLD", "replicated", "1,4")]
QUANT = [(prec, lay) for prec in ("bf16", "int8") for lay in LAYOUTS]
QUANT_LOSS_TOL = {"bf16": 2e-3, "int8": 1e-2}
ROUNDS = 3

_RUNS = {}


def _sp_table_gap(cfg, init, japi):
    """The port's sp engine against the JAX one on ``cfg`` from ``init``:
    the largest difference of a table row after ``ROUNDS`` rounds.
    SCAFFOLD's control variates divide the params' difference by the
    local steps' learning rate, so on a conv net the f32 order of the two
    packages' sums shows there first; the 2-D mesh's rows are held to no
    more than twice this."""
    import torch

    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI
    api = _build(FedAvgAPI, cfg)
    api.reset_params({k: torch.as_tensor(v) for k, v in init.items()})
    for r in range(ROUNDS):
        api.train_one_round(r)
    model = port_model(cfg)
    gap = 0.0
    for i in range(next(iter(api.client_table.values())).shape[0]):
        ref = to_port(jax.tree_util.tree_map(
            lambda l: np.asarray(l)[i], japi.client_table), model)
        gap = max(gap, max(float(np.abs(api.client_table[k][i].numpy()
                                        - v).max()) for k, v in ref.items()))
    return gap


def _runs():
    if _RUNS:
        return _RUNS
    model = port_model(mesh_cfg())
    cnn = port_model(mesh_cfg(**CNN))
    jobs, keys, refs = [], [], {}
    for key in CASES + [k + ("cnn",) for k in CNN_CASES]:
        alg, lay, shape = key[:3]
        net = key[3] if len(key) > 3 else "lr"
        cfg = mesh_cfg(federated_optimizer=alg,
                       **(CNN if net == "cnn" else {}))
        if (alg, net) not in refs:
            # the sp reference does not depend on the mesh: one a config
            japi = jax_api(JFedAvg, cfg)
            init = to_port(jax.device_get(japi.state.global_params),
                           cnn if net == "cnn" else model)
            ms = [japi.train_one_round(r) for r in range(ROUNDS)]
            refs[(alg, net)] = dict(
                japi=japi, init=init, model=cnn if net == "cnn" else model,
                losses=[float(m["train_loss"]) for m in ms],
                sp_table_gap=_sp_table_gap(cfg, init, japi)
                if net == "cnn" else 0.0)
        ref = refs[(alg, net)]
        _RUNS[key] = {k: ref[k] for k in ("japi", "losses", "model",
                                          "sp_table_gap")}
        jobs.append((dict(cfg, update_sharding=lay, mesh_shape=shape),
                     ROUNDS, ref["init"]))
        keys.append(key)
    for prec, lay in QUANT:
        jobs.append((mesh_cfg(federated_optimizer="SCAFFOLD",
                              update_sharding=lay, mesh_shape="2,2",
                              collective_precision=prec), ROUNDS, None))
        keys.append(("quant", prec, lay))
    for lay in LAYOUTS:
        jobs.append((mesh_cfg(federated_optimizer="SCAFFOLD",
                              update_sharding=lay, mesh_shape="2,2"),
                     ROUNDS, None))
        keys.append(("quant", "fp32", lay))
    import tempfile
    tmp = tempfile.mkdtemp(prefix="mesh2d_ck_")
    ck_cfg = mesh_cfg(federated_optimizer="SCAFFOLD", mesh_shape="2,2",
                      collective_precision="int8", update_sharding="scatter")
    blk_cfg = mesh_cfg(federated_optimizer="SCAFFOLD", mesh_shape="2,2",
                       update_sharding="scatter", comm_round=4)
    calls = [("tests.torch_mesh_ranks:mesh2d_cases", (jobs,)),
             ("tests.torch_mesh_ranks:mesh2d_block", (blk_cfg,)),
             ("tests.torch_mesh_ranks:mesh2d_checkpoint", (ck_cfg, tmp)),
             ("tests.torch_mesh_ranks:mesh2d_forms", ())]
    ranks = spawn("tests.torch_mesh_ranks:several_each", N, (calls,),
                  timeout=SPAWN_TIMEOUT)
    for i, key in enumerate(keys):
        _RUNS.setdefault(key, {})["ranks"] = [r[0][i] for r in ranks]
    _RUNS["block"] = ranks[0][1]
    _RUNS["checkpoint"] = ranks[0][2]
    _RUNS["forms"] = [r[3] for r in ranks]
    return _RUNS


@pytest.mark.parametrize("alg,layout,shape,net", [
    k + ("lr",) for k in CASES] + [k + ("cnn",) for k in CNN_CASES])
def test_2d_mesh_matches_jax_sp_engine(alg, layout, shape, net):
    run = _runs()[(alg, layout, shape) + (("cnn",) if net == "cnn" else ())]
    res, japi = run["ranks"][0], run["japi"]
    c, m = (int(v) for v in shape.split(","))
    assert res["shards"] == (c, m) and res["layout"] == layout
    close(res["losses"], run["losses"], f"{alg}/{layout}/{shape} losses")
    model = run["model"]
    for k, v in to_port(japi.state.global_params, model).items():
        close(res["params"][k], v, f"{alg}/{layout}/{shape} {k}")
        close(res["state"]["global_params"][k], v, k)
    if japi.client_table is not None:
        table = res["table"]
        gap = 0.0
        for i in range(next(iter(table.values())).shape[0]):
            ref = to_port(jax.tree_util.tree_map(
                lambda l: np.asarray(l)[i], japi.client_table), model)
            for k, v in ref.items():
                if net == "lr":
                    close(table[k][i], v, f"table row {i} {k}")
                gap = max(gap, float(np.abs(table[k][i] - v).max()))
        if net == "cnn":
            assert gap <= max(2e-5, 2 * run["sp_table_gap"]), \
                (gap, run["sp_table_gap"])
    # every rank's evaluation is the whole model's
    j_loss, j_acc = japi.evaluate()
    for r in run["ranks"]:
        assert abs(r["eval"][0] - j_loss) < 1e-4
        assert abs(r["eval"][1] - j_acc) < 1e-6


@pytest.mark.parametrize("alg,layout,shape", [
    ("FedOpt", "scatter", "2,2"), ("SCAFFOLD", "scatter", "1,4"),
    ("FedOpt", "replicated", "2,2"), ("SCAFFOLD", "replicated", "1,4")])
def test_each_rank_rests_on_its_share(alg, layout, shape):
    """The scatter layout's flat server state: ``1/(c·m)`` of the padded
    flat vector a rank; every matrix leaf ``1/m`` of itself (the
    replicated layout's param-shaped trees with it), vectors whole."""
    ranks = _runs()[(alg, layout, shape)]["ranks"]
    c, m = (int(v) for v in shape.split(","))
    whole = ranks[0]["params"]
    for r in ranks:
        if layout == "scatter":
            assert r["rest"], r
            for field, n in r["rest"].items():
                assert n * c * m == r["padded"], (field, n, r["padded"])
        for k, shp in r["local"].items():
            full = whole[k].shape
            if len(full) >= 2:
                assert int(np.prod(shp)) * m == int(np.prod(full)), k
            else:
                assert tuple(shp) == tuple(full), k


@pytest.mark.parametrize("prec,layout", QUANT)
def test_2d_quantized_merge_tracks_fp32(prec, layout):
    """bf16 and int8 + error feedback on 2 × 2: the losses within the JAX
    package's quantized limits of the fp32 run, and each rank's EF row
    ``(1, L/m)``: its client shard's row, its model column chunk."""
    q = _runs()[("quant", prec, layout)]["ranks"]
    ref = _RUNS[("quant", "fp32", layout)]["ranks"][0]
    gap = float(np.max(np.abs(np.subtract(q[0]["losses"], ref["losses"]))))
    assert gap <= QUANT_LOSS_TOL[prec], gap
    assert all(np.isfinite(q[0]["losses"]))
    for r in q:
        assert r["ef"] == (1, r["padded"] // 2)
    ef = q[0]["state"]["ef_num"]
    assert ef.shape == (2, q[0]["padded"]) and np.abs(ef).max() > 0


@pytest.mark.parametrize("key", [("FedOpt", "scatter", "2,2"),
                                 ("FedOpt", "replicated", "2,2"),
                                 ("SCAFFOLD", "scatter", "1,4"),
                                 ("quant", "int8", "scatter"),
                                 ("quant", "bf16", "replicated")])
def test_collective_bytes_are_the_jax_byte_model(key):
    """``MeshFedAvgAPI.collective_bytes`` against the JAX engine's byte
    model (``fedml_tpu/simulation/mesh/engine.py``'s ``_bytes_model``,
    through ``fedml_tpu.simulation.mesh.collectives``) on the same flat
    sizes, and the port's two functions against the JAX ones."""
    from fedml_tpu.simulation.mesh import collectives as j_coll

    from fedml_tpu_torch.simulation.mesh import collectives as t_coll
    res = _runs()[key]["ranks"][0]
    c, m = res["shards"]
    scatter = res["layout"] == "scatter"
    n_flat = res["padded"] if scatter else res["n_params"]
    mode = res["layout"]
    n_payload = n_flat if scatter else -(-n_flat // m)
    want_c = j_coll.client_axis_bytes(n_payload, c, res["precision"], 256,
                                      mode)
    want_m = j_coll.model_axis_bytes(n_flat, m, mode=mode)
    # the stage axis (the 3-D layout's) moves nothing on 2-D
    want_s = j_coll.stage_axis_bytes(n_flat, 1, mode=mode)
    assert res["bytes"] == {"client": want_c, "stage": want_s,
                            "model": want_m, "total": want_c + want_m}
    assert (want_m > 0) == (scatter and m > 1)
    for args in ((7850, 4, "int8", 256, "scatter"),
                 (7850, 2, "bf16", 64, "replicated"),
                 (1000, 1, "fp32", 256, "scatter")):
        assert t_coll.client_axis_bytes(*args) == \
            j_coll.client_axis_bytes(*args)
        assert t_coll.model_axis_bytes(args[0], args[1], 2, args[4]) == \
            j_coll.model_axis_bytes(args[0], args[1], 2, args[4])


def test_2d_round_block_is_the_unfused_rounds():
    assert _runs()["block"] == 0.0


def test_2d_checkpoint_round_trip_resumes_bitwise():
    """SCAFFOLD with int8 + EF on 2 × 2 (the JAX test's quantized state
    plus a client table): the whole state and table saved after 2 rounds,
    restored into a fresh engine (each rank keeps its shards), then one
    more round: bitwise the uninterrupted run."""
    got = _runs()["checkpoint"]
    assert got["restored"] == 0.0 and got["table"] == 0.0, got
    assert got["resumed"] == 0.0, got


def test_mesh_wire_checkpoint_resumes_bitwise(tmp_path):
    """``checkpoint_codec="wire"`` on the mesh, a world of 1 over gloo:
    SCAFFOLD in the scatter layout writes ``wire_<round>.msgpack`` through
    ``full_state()`` and the client table, and a fresh engine's
    ``maybe_resume`` restores both bitwise, then runs the next round as
    the uninterrupted engine does."""
    from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI
    from .torch_mesh_ranks import _state_diff
    cfg = mesh_cfg(federated_optimizer="SCAFFOLD", backend="mesh",
                   update_sharding="scatter", checkpoint_dir=str(tmp_path),
                   checkpoint_codec="wire", checkpoint_freq=1,
                   checkpoint_keep=1)
    try:
        a = _build(MeshFedAvgAPI, cfg)
        for r in range(2):
            a.train_one_round(r)
            a.maybe_checkpoint(r)
        assert sorted(p.name for p in tmp_path.glob("wire_*")) == \
            ["wire_1.msgpack"]
        b = _build(MeshFedAvgAPI, cfg)
        assert b.maybe_resume() == 2
        assert _state_diff(b.full_state(), a.full_state()) == 0.0
        ta, tb = a.full_client_table(), b.full_client_table()
        assert all(torch.equal(tb[k], ta[k]) for k in ta)
        a.train_one_round(2)
        b.train_one_round(2)
        assert _state_diff(b.full_state(), a.full_state()) == 0.0
        for api in (a, b):
            api._stager.close()
    finally:
        t_mesh.shutdown_world()


def test_make_mesh2d_forms_and_groups():
    forms = _runs()["forms"]
    want = {"2,2": (2, 2), "2x2": (2, 2), "(-1, 2)": (2, 2),
            "[1, 4]": (1, 4), "4,1": (4, 1)}
    for rank, f in enumerate(forms):
        for form, (c, m) in want.items():
            got = f[form]
            assert got["shape"] == (c, m)
            assert got["coords"] == (rank // m, rank % m)
            # the model group: this rank's c_coord; the client group: its
            # m_coord (rank = c_coord * m + m_coord)
            i, j = rank // m, rank % m
            assert got["model_sum"] == sum(i * m + k for k in range(m))
            assert got["client_sum"] == sum(k * m + j for k in range(c))
            assert got["world_sum"] == 6.0
        assert len(f["errors"]) == 2 and "3 x 2" in f["errors"][0]


def test_parse_mesh_shape_forms_match_jax():
    for form in (None, "auto", "4,2", "4x2", (2, 4), [-1, 2], "2,1,4"):
        assert t_mesh.parse_mesh_shape(form) == j_parse(form)
    for bad, what in (("8", "mesh_shape"), ("4,0", "n_model_shards")):
        with pytest.raises(ValueError, match=what):
            t_mesh.parse_mesh_shape(bad)


def test_param_spec_is_the_jax_layouts():
    """The port's rule on the same leaves (flax shapes) as the JAX
    ``MeshLayout.param_spec`` on the 8 virtual CPU devices, for model
    factors 2 and 4; and the dims the engine shards, mapped to the
    port's layouts, on the FEMNIST CNN and ``lr``."""
    leaves = [(4,), (3, 5), (8, 6), (6, 8), (784, 10), (10, 784), (16, 16),
              (5, 5, 1, 32), (3, 3, 32, 64), (7, 3), (2, 2, 2), (12,),
              (1024, 62)]
    for c, m in ((4, 2), (2, 4)):
        jl = JLayout(j_make_mesh2d((c, m), devices=jax.devices()[:c * m]))
        tl = MeshLayout(types.SimpleNamespace(
            client_size=c, model_size=m, size=c * m, rank=0, c_coord=0,
            m_coord=0))
        for shape in leaves:
            want = tuple(jl.param_spec(np.zeros(shape, np.float32)))
            got = tl.param_spec(shape)
            assert tuple(got) == (want or ()), (shape, got, want)
    from fedml_tpu_torch.core.flatmodel import FlatSpec
    for cfg in (mesh_cfg(), mesh_cfg(model="cnn", dataset="femnist",
                                     data_cache_dir="data_shards")):
        model = port_model(cfg)
        params = model.init(__import__("torch").Generator())
        flat = FlatSpec.of(params, 1, model.flat_layout())
        tl = MeshLayout(types.SimpleNamespace(
            client_size=2, model_size=2, size=4, rank=0, c_coord=0,
            m_coord=0))
        tl.bind(flat)
        for name, kind, shape in zip(flat.names, flat.kinds, flat.shapes):
            d = tl.dims[name]
            if len(shape) < 2:
                assert d is None, name
            elif d is not None:
                assert shape[d] % 2 == 0, (name, shape, d)


@pytest.mark.parametrize("engine,over,what", [
    ("mesh", dict(trace=True, trace_device=True), "trace"),
    ("mesh", dict(mesh_data=2), "mesh_data"),
    ("mesh", dict(mesh_seq=2), "mesh_seq"),
    ("hierarchical", dict(client_store=True), "client_store"),
    ("hierarchical", dict(data_paging=True), "data_paging"),
    ("async", dict(registered_clients=64), "registered_clients"),
    ("async", dict(checkpoint_dir="/nonexistent"), "checkpoint_dir"),
    ("hierarchical", dict(mesh_shape="1,2"), "MeshHierarchicalAPI"),
    ("decentralized", dict(mesh_model=2), "MeshDecentralizedAPI"),
    ("mesh", dict(health=True, group_num=1), "health"),
    ("tp_heads", {}, "does not divide n_heads"),
    ("make_mesh", {}, "data")])
def test_refusals_that_stay(engine, over, what):
    """Each still raises by name: the data factor, and a seq factor on
    the simulation engine (ring attention runs in the causal LM); of the
    obs options (run on the mesh engine since they were ported) the
    measured ``trace_device`` probe on the mesh engine and ``health`` on
    the hierarchical mesh engine; the client-state options
    and checkpoint_dir on the hierarchical and async_fedavg engines (the
    sp and mesh FedAvg engines run them); a model factor on the
    hierarchical and decentralized mesh engines; a TP degree that does
    not divide n_heads."""
    from fedml_tpu_torch.llm.model import TINY, LlamaLM
    from fedml_tpu_torch.simulation.mesh.decentralized_mesh import \
        MeshDecentralizedAPI
    from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI
    from fedml_tpu_torch.simulation.mesh.hierarchical_mesh import \
        MeshHierarchicalAPI
    from fedml_tpu_torch.simulation.sp.async_fedavg import AsyncFedAvgAPI
    with pytest.raises(NotImplementedError, match=what):
        if engine == "mesh" and "group_num" in over:
            _build(MeshHierarchicalAPI, mesh_cfg(**over))
        elif engine == "mesh":
            # refused before any process group is made
            _build(MeshFedAvgAPI, dict(mesh_cfg(**over), backend="NCCL"))
        elif engine == "hierarchical":
            _build(MeshHierarchicalAPI, dict(mesh_cfg(**over), group_num=1))
        elif engine == "async":
            _build(AsyncFedAvgAPI, dict(mesh_cfg(**over),
                                        federated_optimizer="async_fedavg"))
        elif engine == "decentralized":
            _build(MeshDecentralizedAPI, dict(
                mesh_cfg(**over), federated_optimizer="dsgd",
                topology="symmetric", topology_neighbors=2))
        elif engine == "tp_heads":
            mesh = t_mesh.Mesh(3, 0, "cpu", model=3)
            with __import__("torch").device("meta"):
                LlamaLM(TINY, mesh=mesh)
        else:
            t_mesh.make_mesh(data=2, device="cpu")
