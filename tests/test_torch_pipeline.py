"""The port's 3-D ``client × stage × model`` pipeline on 4 gloo ranks, on
the CPU, against the JAX package.

- ``ops/pipeline.py::pipeline_apply`` forward and backward against the
  JAX ``pipeline_apply`` in a fully manual ``jax.shard_map`` over 4
  stages (``tests/test_pipeline.py``'s shapes and limits);
- ``MeshFedAvgAPI`` with ``mesh_shape="c,s,m"`` on ``pipe_mlp`` (16 wide,
  4 layers, ``microbatches`` 4: ``tests/test_mesh3d.py``'s arguments)
  against the JAX sp engine, for FedAvg, FedOpt and SCAFFOLD at (2,2,1)
  scatter and (1,2,2) replicated.  The JAX 3-D engine itself needs
  ``shard_map(auto=...)``, which this image's jax refuses; the JAX test
  holds the 3-D layout to the sp engine at 2e-5 (FedOpt's sp band:
  1e-4 on the losses, 5e-3 on the params, its server Adam amplifying
  the order of the f32 sums), and so does this file;
- ``round_block`` on the 3-D layout, with a ragged last block, bitwise
  the unfused rounds;
- each rank's resting share (its stage's layers, its rows of them, and
  ``1/(c·s·m)`` of the flat state), the layout's staged specs against
  the JAX ``MeshLayout.param_spec``, the stage byte model against the
  JAX one, and every refusal of the pipeline gate of ``validate_args``.

One spawn of 4 ranks runs every multi-rank case of the file."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.core.mesh import make_mesh2d as j_make_mesh2d
from fedml_tpu.ops.pipeline import pipeline_apply as j_pipeline_apply
from fedml_tpu.simulation.mesh import collectives as j_coll
from fedml_tpu.simulation.mesh.layout import MeshLayout as JLayout
from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvg

from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.simulation.mesh import collectives as t_coll
from fedml_tpu_torch.simulation.mesh.launch import spawn
from fedml_tpu_torch.simulation.mesh.layout import MeshLayout

from .torch_mesh_parity import SPAWN_TIMEOUT, close, jax_api, port_model, \
    to_port

N = 4
ALGS = ["FedAvg", "FedOpt", "SCAFFOLD"]
SHAPES = (("2,2,1", "scatter"), ("1,2,2", "replicated"))
ROUNDS = 3
#: tests/test_mesh3d.py's band for the sp engine (FedOpt looser)
LOSS_TOL = {"FedOpt": 1e-4}
PARAM_TOL = {"FedOpt": 5e-3}


def cfg_for(**over):
    """``tests/test_mesh3d.py::args_for`` (16 clients, 8 a round,
    ``pipe_mlp`` 16 wide and 4 deep, homo partition, seed 7)."""
    cfg = dict(dataset="synthetic", num_classes=10, input_shape=(28, 28, 1),
               train_size=1024, test_size=256, client_num_in_total=16,
               client_num_per_round=8, comm_round=ROUNDS, epochs=1,
               batch_size=16, learning_rate=0.1, random_seed=7,
               partition_method="homo", frequency_of_the_test=10 ** 9,
               model="pipe_mlp", model_dim=16, model_layers=4,
               data_cache_dir="")
    cfg.update(over)
    if str(cfg.get("federated_optimizer", "")).lower() == "fedopt":
        cfg.setdefault("server_lr", 0.03)
    return cfg


def _stage_fn(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _pipeline_inputs():
    """``tests/test_pipeline.py``'s shapes (4 stages, 5 microbatches of
    2, width 8) as numpy from a seed."""
    rng = np.random.RandomState(2)
    ws = (rng.randn(N, 8, 8) * 0.3).astype(np.float32)
    bs = (rng.randn(N, 8) * 0.1).astype(np.float32)
    micro = rng.randn(5, 2, 8).astype(np.float32)
    tgt = rng.randn(5, 2, 8).astype(np.float32)
    return ws, bs, micro, tgt


def _jax_pipeline(ws, bs, micro, tgt):
    mesh = Mesh(np.array(jax.devices()[:N]), ("stage",))

    def inner(params_shard, mb):
        local = jax.tree_util.tree_map(lambda a: a[0], params_shard)
        return j_pipeline_apply(_stage_fn, local, mb, "stage")

    fwd = jax.shard_map(inner, mesh=mesh, in_specs=(P("stage"), P()),
                        out_specs=P(), check_vma=False)

    def loss(stacked, mb):
        return jnp.sum((fwd(stacked, mb) - tgt) ** 2)

    out = jax.jit(fwd)((ws, bs), micro)
    grads = jax.jit(jax.grad(loss))((ws, bs), micro)
    return np.asarray(out), [np.asarray(g) for g in grads]


_RUNS = {}


def _runs():
    if _RUNS:
        return _RUNS
    model = port_model(cfg_for())
    jobs, keys = [], []
    for alg in ALGS:
        cfg = cfg_for(federated_optimizer=alg)
        japi = jax_api(JFedAvg, cfg)
        init = to_port(jax.device_get(japi.state.global_params), model)
        ms = [japi.train_one_round(r) for r in range(ROUNDS)]
        _RUNS[alg] = dict(losses=[float(m["train_loss"]) for m in ms],
                          params=to_port(japi.state.global_params, model))
        for shape, lay in SHAPES:
            jobs.append((dict(cfg, mesh_shape=shape, microbatches=4,
                              update_sharding=lay), ROUNDS, init))
            keys.append((alg, shape))
    pipe_in = _pipeline_inputs()
    _RUNS["pipe_ref"] = _jax_pipeline(*pipe_in)
    blk_cfg = cfg_for(federated_optimizer="SCAFFOLD", mesh_shape="2,2,1",
                      microbatches=2, round_block=2, update_sharding="scatter")
    calls = [("tests.torch_mesh_ranks:pipeline_apply_case", pipe_in),
             ("tests.torch_mesh_ranks:mesh2d_cases", (jobs,)),
             ("tests.torch_mesh_ranks:mesh_block_ragged", (blk_cfg,))]
    ranks = spawn("tests.torch_mesh_ranks:several_each", N, (calls,),
                  timeout=SPAWN_TIMEOUT)
    _RUNS["pipe"] = [r[0] for r in ranks]
    for i, key in enumerate(keys):
        _RUNS[key] = [r[1][i] for r in ranks]
    _RUNS["block"] = ranks[0][2]
    return _RUNS


def test_pipeline_apply_forward_and_backward_match_jax():
    """The output on every rank, and each stage's gradients, against the
    JAX schedule under ``jax.grad`` (``tests/test_pipeline.py``'s limits:
    1e-5 forward, 1e-4 backward)."""
    runs = _runs()
    out, (gw, gb) = runs["pipe_ref"]
    for s, r in enumerate(runs["pipe"]):
        np.testing.assert_allclose(r["out"], out, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(r["gw"], gw[s], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(r["gb"], gb[s], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("shape,layout", SHAPES)
def test_3d_mesh_matches_jax_sp_engine(alg, shape, layout):
    runs = _runs()
    ref = runs[alg]
    for res in runs[(alg, shape)]:
        assert res["layout"] == layout
        close(res["losses"], ref["losses"], f"{alg}/{shape} losses",
              atol=LOSS_TOL.get(alg, 2e-5))
        for k, v in ref["params"].items():
            close(res["params"][k], v, f"{alg}/{shape} {k}",
                  atol=PARAM_TOL.get(alg, 2e-5))


@pytest.mark.parametrize("shape,layout", SHAPES)
def test_each_rank_rests_on_its_share(shape, layout):
    """A rank keeps its stage's ``depth/s`` layers of ``blocks_w`` and
    ``blocks_b`` and (``m > 1``) its ``1/m`` of each layer's rows; the
    embed and head whole; in the scatter layout ``1/(c·s·m)`` of the
    padded flat state."""
    c, s, m = (int(v) for v in shape.split(","))
    for res in _runs()[("FedOpt", shape)]:
        assert res["local"]["blocks_w"] == (4 // s, 16 // m, 16)
        assert res["local"]["blocks_b"] == (4 // s, 16)
        assert res["local"]["embed.weight"] == (16, 784)
        assert res["local"]["head.weight"] == (10, 16)
        if layout == "scatter":
            assert res["rest"]
            for field, n in res["rest"].items():
                assert n * c * s * m == res["padded"], field


def test_3d_round_block_ragged_tail_is_the_unfused_rounds():
    """SCAFFOLD at (2,2,1), ``round_block`` 2 over 3 rounds (a block of
    2, then one of 1): bitwise the unfused rounds."""
    assert _runs()["block"] == 0.0


def test_staged_specs_are_the_jax_layouts():
    """The port's ``param_spec`` on the pipeline layout against the JAX
    ``MeshLayout.param_spec`` on a (2,2,2) mesh of the virtual CPU
    devices (staged: layer axis over stage, rows over model for ndim >=
    3; others whole), and the splits the layout binds on ``pipe_mlp``."""
    jl = JLayout(j_make_mesh2d((2, 2, 2), devices=jax.devices()[:8]),
                 stage_leaves=("blocks_w", "blocks_b"))
    tl = MeshLayout(types.SimpleNamespace(
        client_size=2, stage_size=2, model_size=2, size=8, rank=0,
        c_coord=0, s_coord=0, m_coord=0), ("blocks_w", "blocks_b"))
    for shape in ((4, 16, 16), (4, 16), (8, 6, 3), (4, 3, 5), (784, 16),
                  (16,), (10, 16)):
        for staged in (True, False):
            want = tuple(jl.param_spec(np.zeros(shape, np.float32), staged))
            assert tuple(tl.param_spec(shape, staged)) == (want or ()), \
                (shape, staged)
    from fedml_tpu_torch.core.flatmodel import FlatSpec
    model = port_model(cfg_for())
    params = model.init(__import__("torch").Generator())
    tl.bind(FlatSpec.of(params, 1, model.flat_layout()))
    assert tl.splits == {"blocks_w": ((0, "stage"), (1, "model")),
                         "blocks_b": ((0, "stage"),), "embed.weight": (),
                         "embed.bias": (), "head.weight": (),
                         "head.bias": ()}


def test_stage_bytes_are_the_jax_byte_model():
    """``stage_axis_bytes`` against the JAX one, the JAX test's
    hand-checked train plane (1536 bytes) included; and a run's
    ``collective_bytes`` against the JAX model on its flat sizes: client
    + stage + model = total."""
    for args in ((7850, 2, 4, "scatter", 8, 4, 2, 2),
                 (7850, 2, 4, "replicated", 8, 4, 2, 2),
                 (3455, 4, 4, "scatter", 16, 4, 4, 4),
                 (3455, 1, 4, "scatter", 16, 4, 4, 4)):
        n, s, pb, mode, hidden, mb, k, steps = args
        assert t_coll.stage_axis_bytes(n, s, pb, mode, hidden, mb, k,
                                       steps) == \
            j_coll.stage_axis_bytes(n, s, pb, mode, hidden, mb, k, steps)
    assert t_coll.stage_axis_bytes(0, 2, mode="replicated", hidden=8,
                                   microbatch=4, n_micro=2,
                                   steps=2) == 1536.0
    for shape, layout in SHAPES:
        res = _runs()[("FedAvg", shape)][0]
        c, s, m = (int(v) for v in shape.split(","))
        scatter = layout == "scatter"
        n_flat = res["padded"] if scatter else res["n_params"]
        n_payload = n_flat if scatter else -(-n_flat // (m * s))
        want = dict(
            client=j_coll.client_axis_bytes(n_payload, c, "fp32", 256,
                                            layout),
            stage=j_coll.stage_axis_bytes(n_flat, s, mode=layout, hidden=16,
                                          microbatch=4, n_micro=4, steps=4),
            model=j_coll.model_axis_bytes(n_flat, m, mode=layout))
        want["total"] = want["client"] + want["stage"] + want["model"]
        assert res["bytes"] == want, (shape, res["bytes"], want)


@pytest.mark.parametrize("over,flag", [
    (dict(population=2), "population"),
    (dict(population_axes={"client_lr": [0.1, 0.2]}), "population"),
    (dict(federated_optimizer="FedBuff"), "fedbuff"),
    (dict(cohort_bucketing=True), "cohort_bucketing"),
    (dict(federated_optimizer="FedProx"), "fedprox"),
    (dict(federated_optimizer="FedDyn"), "feddyn"),
    (dict(microbatches=3), "microbatches"),
    (dict(mesh_shape=None, mesh_stage=2, cohort_bucketing=True),
     "mesh_stage")])
def test_validate_args_refuses_what_the_pipeline_cannot_run(over, flag):
    """The pipeline gate raises at ``init()`` naming the flag, as the JAX
    package's ``validate_args`` does for the same arguments."""
    cfg = cfg_for(**{"mesh_shape": "2,2,2", **over})
    with pytest.raises(ValueError, match=flag):
        fedml_tpu.init(j_arguments().update(**cfg), should_init_logs=False)
    with pytest.raises(ValueError, match=flag):
        fedml_tpu_torch.init(t_arguments().update(**cfg),
                             should_init_logs=False)


def test_an_unstaged_model_is_refused_before_any_process_group():
    """``lr`` carries no ``PipelineDef``: a 3-tuple mesh shape raises by
    name before any process group is made (the JAX layout's refusal)."""
    import torch.distributed as dist

    from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI

    from .torch_mesh_ranks import _build
    made = dist.is_initialized()
    with pytest.raises(ValueError, match="staged model"):
        _build(MeshFedAvgAPI, cfg_for(model="lr", mesh_shape="2,2,2"))
    assert dist.is_initialized() == made
