"""The port's cross-silo options against the JAX package's, on the CPU,
and what the port refuses.

- A dropped upload (``tests/test_chaos.py``'s 25% of the uploads, seeded
  so that silo 1's round-2 and silo 2's round-1 uploads drop: the JAX
  test's seed 3 drops none of these six) is absorbed by
  ``aggregation_timeout_s`` as in the JAX run: the same rounds close
  short, and the final params agree.
- ``checkpoint_dir`` resumes at the JAX test's rounds (latest 1, then 3)
  and ends where the resumed JAX run does.
- Silo partials (``add_local_partial_aggregate``) combine to the flat
  merge over the union of the silos' clients.
- Three OS processes started by ``CrossSiloLauncher`` (``FEDML_TPU_RANK``
  / ``_ROLE`` / ``_RUN_ID``), each with ``jax`` unimportable, run
  ``run_cross_silo_server``/``run_cross_silo_client`` over ``filestore``
  and end bitwise where the same federation in threads does.
- Every refused backend, scenario, slave rank, trust-stack flag,
  unported class and training type raises by name; the entry points
  never fall back to the CPU unasked.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.core.alg_frame.client_trainer import TRUST_STACK_FLAGS

from .torch_cross_silo_parity import (LR, args_for, assert_params_close,
                                      assert_params_equal, jax_federation,
                                      port_federation)

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: tests/test_chaos.py::test_cross_silo_survives_dropped_upload_via_timeout
#: but for the seed: chaos seed 1 drops silo 1's upload of round 2 and silo
#: 2's of round 1 (each rank's numpy stream, seed·1000 + rank, draws 3
#: numbers a send, the first against the drop probability)
DROP = dict(comm_round=3, chaos_seed=1, chaos_drop_prob=0.25,
            chaos_droppable_types=[3], aggregation_timeout_s=3.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_dropped_upload_is_absorbed_by_the_timeout_as_in_jax():
    jx = jax_federation(LR, "local", "tj_drop", **DROP)
    pt = port_federation(LR, "local", "tp_drop", init=jx["init"], **DROP)
    # the chaos draws are the same seeded numpy streams in both packages:
    # the same uploads were dropped, so the same rounds closed short
    j_chaos = jx["server"].server_manager.com_manager
    p_chaos = pt["server"].server_manager.com_manager
    assert type(p_chaos).__name__ == "FaultInjectingCommManager"
    assert [pt["clients"][r].client_manager.com_manager.stats["dropped"]
            for r in (1, 2)] == [1, 1]
    assert p_chaos.stats == j_chaos.stats
    assert_params_close(pt, jx["params"])
    assert pt["acc"] == jx["acc"]


def test_checkpoint_resumes_at_the_jax_rounds(tmp_path):
    from fedml_tpu.core.checkpoint import RoundCheckpointer as JCkpt

    from fedml_tpu_torch.core.checkpoint import RoundCheckpointer as TCkpt

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j1 = jax_federation(LR, "local", "tj_ck1", checkpoint_dir=jdir,
                        checkpoint_freq=1, comm_round=2)
    t1 = port_federation(LR, "local", "tp_ck1", init=j1["init"],
                         checkpoint_dir=tdir, checkpoint_freq=1, comm_round=2)
    assert JCkpt(jdir).latest_round() == TCkpt(tdir).latest_round() == 1
    assert_params_close(t1, j1["params"])
    # restart with more rounds: both resume at round 2 from their own
    # checkpoint (no init given to the port: the restored state stands)
    j2 = jax_federation(LR, "local", "tj_ck2", checkpoint_dir=jdir,
                        checkpoint_freq=1, comm_round=4)
    t2 = port_federation(LR, "local", "tp_ck2", checkpoint_dir=tdir,
                         checkpoint_freq=1, comm_round=4)
    assert JCkpt(jdir).latest_round() == TCkpt(tdir).latest_round() == 3
    assert [r["round"] for r in t2["clients"][1].client_manager.timings] \
        == [2, 3]
    assert t2["server"].aggregator.state.round_idx == 4
    assert_params_close(t2, j2["params"])
    assert t2["acc"] == j2["acc"]


def test_silo_partials_combine_to_the_flat_merge():
    from fedml_tpu_torch.core import tree as tree_util
    from fedml_tpu_torch.cross_silo.server import FedMLAggregator

    a = fedml_tpu_torch.load_arguments().update(**LR)
    ds, n_out = t_data.load(a)
    m = t_model.create(a, n_out)
    gen = torch.Generator().manual_seed(3)
    clients = [{k: v + 0.01 * torch.randn(v.shape, generator=gen)
                for k, v in m.init(gen).items()} for _ in range(5)]
    w = torch.tensor([3.0, 1.0, 4.0, 1.0, 5.0])
    flat = FedMLAggregator(a, m, ds, 2, device="cpu")
    ref = flat.server_opt.update(flat.state, tree_util.tree_stack(clients), w)
    two = FedMLAggregator(a, m, ds, 2, device="cpu")
    opt = two.server_opt
    for silo, rows in enumerate(((0, 1), (2, 3, 4))):
        stacked = tree_util.tree_stack([clients[i] for i in rows])
        part = opt.compute_partial_aggregates(two.state, stacked, w[list(rows)])
        two.add_local_partial_aggregate(silo, part, float(w[list(rows)].sum()))
    assert two.check_whether_all_receive()
    got = two.aggregate()
    for k, v in ref.global_params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert two.state.round_idx == 1


ENTRY = '''
import json, os, sys
for name in ("jax", "jaxlib", "flax", "optax", "fedml_tpu"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import fedml_tpu_torch
from fedml_tpu_torch.cross_silo.client.client_launcher import (
    env_rank, env_role, env_run_id)

cfg = json.loads(os.environ["XS_CFG"])
args = fedml_tpu_torch.load_arguments().update(**cfg)
args.update(rank=env_rank(), run_id=env_run_id(), backend="filestore",
            training_type="cross_silo")
if env_role() == "server":
    params = fedml_tpu_torch.run_cross_silo_server(args, device="cpu")
    torch.save({k: v.cpu() for k, v in params.items()}, os.environ["XS_OUT"])
else:
    fedml_tpu_torch.run_cross_silo_client(args, device="cpu")
'''


def test_three_process_federation_matches_the_threads(tmp_path):
    from fedml_tpu_torch.cross_silo.client.client_launcher import \
        CrossSiloLauncher

    entry = tmp_path / "entry.py"
    entry.write_text(ENTRY)
    cfg = dict(LR, client_id_list=[1, 2],
               filestore_dir=str(tmp_path / "fs_proc"))
    out = tmp_path / "server_params.pt"
    launcher = CrossSiloLauncher(
        str(entry), run_id="xs_proc", client_ranks=[1, 2],
        extra_env={"XS_CFG": json.dumps(cfg), "XS_OUT": str(out),
                   "PYTHONPATH": str(ROOT)})
    assert launcher.run(timeout_s=60) == [0, 0, 0]
    threads = port_federation(
        LR, "filestore", "xs_threads",
        filestore_dir=str(tmp_path / "fs_threads"))
    assert_params_equal(torch.load(out), threads["params"])


def test_init_normalises_client_id_list_as_jax_does():
    from fedml_tpu import _update_client_id_list as j_update

    for cur in ("[]", None, "[3, 5]", "not json", [7, 8]):
        class J:
            client_num_in_total = 3
            client_id_list = cur
        j_update(J)
        a = fedml_tpu_torch.init(fedml_tpu_torch.load_arguments().update(
            training_type="cross_silo", client_num_in_total=3,
            client_id_list=cur), should_init_logs=False)
        assert a.client_id_list == J.client_id_list


def _server_or_client(role, backend="local", **over):
    from fedml_tpu_torch.cross_silo.client import Client
    from fedml_tpu_torch.cross_silo.server import Server

    a = args_for("port", dict(LR, train_size=64, test_size=16), backend,
                 0 if role == "server" else 1, f"refuse_{role}", **over)
    ds, n_out = t_data.load(a)
    m = t_model.create(a, n_out)
    cls = Server if role == "server" else Client
    return cls(a, "cpu", ds, m)


@pytest.mark.parametrize("role", ["server", "client"])
@pytest.mark.parametrize("flag", sorted(TRUST_STACK_FLAGS))
def test_trust_stack_flags_raise_by_name(flag, role):
    with pytest.raises(NotImplementedError, match=flag):
        _server_or_client(role, **{flag: True})


@pytest.mark.parametrize("backend", ["GRPC", "TRPC", "MQTT_WEB3",
                                     "MQTT_THETA", "MQTT_S3_MNN", "CASTORE"])
def test_refused_backends_raise_at_the_server(backend):
    with pytest.raises(NotImplementedError, match=backend):
        _server_or_client("server", backend=backend)


@pytest.mark.parametrize("over, name", [
    (dict(scenario="hierarchical"), "hierarchical"),
    (dict(proc_rank_in_silo=1), "proc_rank_in_silo")])
def test_hierarchical_scenario_and_slave_ranks_raise_by_name(over, name):
    with pytest.raises(NotImplementedError, match=name):
        _server_or_client("client", **over)


@pytest.mark.parametrize("module, name", [
    ("fedml_tpu_torch.cross_silo.server", "AsyncFedMLServerManager"),
    ("fedml_tpu_torch.cross_silo.client", "ClientSlaveManager"),
    ("fedml_tpu_torch.cross_silo.client", "ProcessGroupManager")])
def test_unported_classes_raise_by_name(module, name):
    import importlib

    with pytest.raises(NotImplementedError, match=name):
        getattr(importlib.import_module(module), name)


def test_user_aggregator_with_a_trust_flag_raises_by_name():
    from fedml_tpu_torch.core.alg_frame.server_aggregator import \
        ServerAggregator

    class Agg(ServerAggregator):
        get_model_params = set_model_params = aggregate = test = \
            lambda *a: None

    with pytest.raises(NotImplementedError, match="enable_compression"):
        Agg(None, fedml_tpu_torch.load_arguments().update(
            enable_compression=True))


def test_cross_device_training_type_raises_by_name():
    from fedml_tpu_torch.runner import FedMLRunner

    a = fedml_tpu_torch.load_arguments().update(training_type="cross_device")
    with pytest.raises(NotImplementedError, match="cross_device"):
        FedMLRunner(a, "cpu", None, None)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a CPU-only host")
@pytest.mark.parametrize("entry", ["run_cross_silo_server",
                                   "run_cross_silo_client"])
def test_entry_points_default_to_the_card_and_never_fall_back(entry):
    a = args_for("port", LR, "local", 0, "nocard")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(fedml_tpu_torch, entry)(a)
