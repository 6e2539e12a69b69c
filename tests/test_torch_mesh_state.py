"""The client-state plane on the port's mesh engine, on 4 gloo ranks on the
CPU, against the JAX package.

- ``MeshFedAvgAPI`` with ``registered_clients`` (64 ids over 16 dataset
  clients), ``client_store`` (each rank's store holding its client
  shard's ids and its shard of each row) and ``data_paging``, on the 1-D
  and the 2-D ``(2, 2)`` meshes, and on ``pipe_mlp`` (16 wide, 4 deep) at
  the 3-D ``(2, 2, 1)`` and ``(1, 2, 2)`` pipeline layouts (the store's
  rows split over stage and model), against the JAX sp engine with the same
  options (the JAX mesh engine needs ``shard_map(auto=...)``, which this
  image's jax refuses; the mesh parity limits of
  ``tests/torch_mesh_parity.py``): the losses, the params and every
  registered id's row of the store, or of the dense table;
- the two 3-D checkpoint round trips of ``tests/test_mesh3d.py``
  (``checkpoint_dir``, ``maybe_checkpoint``/``maybe_resume``): FedOpt
  with int8 collectives restored into the same ``(2, 2, 1)`` mesh
  (bitwise, then the uninterrupted curve), and a ``(1, 2, 2)`` run
  restored into the 2-D ``(1, 4)`` mesh of the same ranks (the same
  flat padding and client factor), continuing within 2e-5 of the
  uninterrupted 3-D run.

One spawn of 4 ranks runs every multi-rank case of the file."""

import tempfile

import jax
import numpy as np
import pytest

from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvg

from fedml_tpu_torch.simulation.mesh.launch import spawn

from .torch_mesh_parity import (SPAWN_TIMEOUT, close, jax_api, mesh_cfg,
                                port_model, to_port)

N = 4
ROUNDS = 3
PLANE = dict(federated_optimizer="SCAFFOLD", registered_clients=64)
STATE_CASES = {
    "store_1d": dict(client_store=True, store_page_size=4,
                     data_paging=True, data_page_size=64),
    "store_2d": dict(client_store=True, store_page_size=4,
                     mesh_shape="2,2"),
    "dense_1d": dict(),
    "store_3d_221": dict(client_store=True, store_page_size=4,
                         mesh_shape="2,2,1", microbatches=4),
    "store_3d_122": dict(client_store=True, store_page_size=4,
                         mesh_shape="1,2,2", microbatches=4),
}
#: the staged model of the 3-D cases (``tests/test_mesh3d.py``'s)
PIPE_MODEL = dict(model="pipe_mlp", model_dim=16, model_layers=4,
                  partition_method="homo")
PIPE = dict(model="pipe_mlp", model_dim=16, model_layers=4,
            partition_method="homo", microbatches=4,
            federated_optimizer="FedOpt", server_lr=0.03)

_RUNS = {}


def _runs():
    if _RUNS:
        return _RUNS
    refs = {}
    for store, staged in ((True, False), (False, False), (True, True)):
        over = PIPE_MODEL if staged else {}
        model = port_model(mesh_cfg(**over))
        cfg = mesh_cfg(**PLANE, **over, client_store=store,
                       store_page_size=4)
        japi = jax_api(JFedAvg, cfg)
        init = to_port(jax.device_get(japi.state.global_params), model)
        ms = [japi.train_one_round(r) for r in range(ROUNDS)]
        if store:
            japi._pager.drain_writebacks()
            rows = japi._store.gather(np.arange(64))
        else:
            rows = japi.client_table
        refs[store, staged] = dict(
            init=init, losses=[float(m["train_loss"]) for m in ms],
            params=to_port(japi.state.global_params, model),
            rows=[to_port(jax.tree_util.tree_map(
                lambda l: np.asarray(l)[i], rows), model) for i in range(64)])
    jobs = []
    for name, over in STATE_CASES.items():
        staged = "microbatches" in over
        ref = refs[bool(over.get("client_store")), staged]
        _RUNS[name] = dict(ref=ref)
        jobs.append((mesh_cfg(**PLANE, **over,
                              **(PIPE_MODEL if staged else {})),
                     ref["init"]))
    same = mesh_cfg(**PIPE, mesh_shape="2,2,1", collective_precision="int8")
    other = mesh_cfg(**PIPE, mesh_shape="1,2,2")
    calls = [("tests.torch_mesh_ranks:mesh_state", (jobs, ROUNDS)),
             ("tests.torch_mesh_ranks:mesh3d_checkpoint",
              (same, same, tempfile.mkdtemp(prefix="mesh3d_ck_"))),
             ("tests.torch_mesh_ranks:mesh3d_checkpoint",
              (other, dict(other, mesh_shape="1,4"),
               tempfile.mkdtemp(prefix="mesh3d_ck_")))]
    ranks = spawn("tests.torch_mesh_ranks:several", N, (calls,),
                  timeout=SPAWN_TIMEOUT)
    states, _RUNS["same"], _RUNS["into_2d"] = ranks[0]
    for name, res in zip(STATE_CASES, states):
        _RUNS[name]["port"] = res
    return _RUNS


@pytest.mark.parametrize("name", list(STATE_CASES))
def test_mesh_state_plane_matches_jax_sp_engine(name):
    run = _runs()[name]
    ref, res = run["ref"], run["port"]
    close(res["losses"], ref["losses"], f"{name} losses")
    for k, v in ref["params"].items():
        close(res["params"][k], v, f"{name} {k}")
    # the registered ids widen the sampled space past the dataset's 16
    assert res["sampled"] >= 16
    assert res["paged"] == ("data_paging" in STATE_CASES[name])
    shape = STATE_CASES[name].get("mesh_shape")
    if shape is not None:
        dims = tuple(int(d) for d in shape.split(","))
        assert res["shards"] == (dims if len(dims) == 3 else
                                 (dims[0], 1, dims[1]))
    assert res["pipeline"] == ("microbatches" in STATE_CASES[name])
    if res["rows"] is not None:
        ids = list(res["rows"]["ids"])
        assert ids and all(0 <= i < 64 for i in ids)
        for i, row in enumerate(ref["rows"]):
            for k, v in row.items():
                got = res["rows"][k][ids.index(i)] if i in ids \
                    else np.zeros_like(v)
                close(got, v, f"{name} row {i} {k}")
    else:
        for i, row in enumerate(ref["rows"]):
            for k, v in row.items():
                close(res["table"][k][i], v, f"{name} row {i} {k}")


def test_3d_checkpoint_restores_into_the_same_mesh():
    """FedOpt, int8 collectives with error feedback, ``(2, 2, 1)``: the
    stage-sharded state saved after 2 rounds comes back bitwise, and the
    next round is the uninterrupted run's."""
    got = _runs()["same"]
    assert got["start"] == 2 and got["shards"] == (2, 2, 1)
    assert got["restored"] == 0.0
    assert got["resumed"] == 0.0


def test_3d_checkpoint_restores_into_a_2d_mesh():
    """A ``(1, 2, 2)`` run's checkpoint restored into the 2-D ``(1, 4)``
    mesh of the same ranks: the next round within 2e-5 of the
    uninterrupted 3-D run (the JAX test's limit: 3-D ≡ 2-D)."""
    got = _runs()["into_2d"]
    assert got["start"] == 2 and got["shards"] == (1, 1, 4)
    assert got["resumed"] <= 2e-5, got
