"""``checkpoint_dir`` on the port's sp engines, on the CPU: a run stopped
after round r and resumed from its checkpoint ends bitwise where the
uninterrupted run ends (server state, optimizer state and per-client
state), for the dense table, the client store (its sparse sidecar), a
fused block and FedBuff; ``checkpoint_keep`` prunes steps and sidecars; a
dense checkpoint restores into a store-backed run; ``checkpoint_codec=
"wire"`` selects the wire-format checkpointer (its round trips are in
``tests/test_torch_wire.py``).  The JAX engines' orbax checkpoints are not
read by the port, so the contract is the port's own resume."""

import os

import numpy as np
import pytest
import torch

from fedml_tpu_torch.core.checkpoint import (RoundCheckpointer,
                                             WireCheckpointer,
                                             state_from_flat, state_to_flat)
from fedml_tpu_torch.simulation.async_engine import FedBuffAPI
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

from .torch_sp_parity import base_args, port

CFG = dict(client_num_in_total=12, client_num_per_round=6, comm_round=8,
           frequency_of_the_test=3)


def _client_rows(api):
    if api._store is not None:
        return api._store.gather(np.arange(api.registered_clients))
    if api.client_table is None:
        return {}
    return {k: v.numpy() for k, v in api.client_table.items()}


def _resumed_equals_uninterrupted(tmp_path, cls=FedAvgAPI, stop=4, **over):
    full = port(cls, base_args(**CFG, **over))
    full.train()
    ckpt = str(tmp_path / "ckpt")
    first = port(cls, base_args(**{**CFG, "comm_round": stop},
                                checkpoint_dir=ckpt, checkpoint_freq=3,
                                **over))
    first.train()
    resumed = port(cls, base_args(**CFG, checkpoint_dir=ckpt,
                                  checkpoint_freq=3, **over))
    assert resumed.maybe_resume() == stop
    resumed = port(cls, base_args(**CFG, checkpoint_dir=ckpt,
                                  checkpoint_freq=3, **over))
    resumed.train()
    assert [m["round"] for m in resumed.metrics_history] == \
        list(range(stop, CFG["comm_round"]))
    a, b = state_to_flat(full.state), state_to_flat(resumed.state)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    ra, rb = _client_rows(full), _client_rows(resumed)
    assert set(ra) == set(rb)
    for k in ra:
        np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)
    return full, resumed, ckpt


@pytest.mark.parametrize("opt", ["SCAFFOLD", "FedOpt"])
def test_dense_run_resumes_bitwise(tmp_path, opt):
    full, resumed, _ = _resumed_equals_uninterrupted(
        tmp_path, federated_optimizer=opt)
    if opt == "FedOpt":
        assert full.state.opt_state is not None


def test_store_run_resumes_bitwise_from_its_sidecar(tmp_path):
    _, resumed, ckpt = _resumed_equals_uninterrupted(
        tmp_path, federated_optimizer="SCAFFOLD", client_store=True,
        store_page_size=4, registered_clients=40)
    files = sorted(os.listdir(ckpt))
    assert any(f.startswith("store_") for f in files)
    # keep=3: steps and sidecars are pruned together
    steps = {f[5:-3] for f in files if f.startswith("step_")}
    sides = {f[6:-4] for f in files if f.startswith("store_")}
    assert steps == sides and len(steps) <= 3


def test_fused_block_store_run_resumes_bitwise(tmp_path):
    _resumed_equals_uninterrupted(
        tmp_path, federated_optimizer="SCAFFOLD", client_store=True,
        store_page_size=4, round_block=2)


def test_fedbuff_run_resumes_bitwise(tmp_path):
    _, resumed, _ = _resumed_equals_uninterrupted(
        tmp_path, cls=FedBuffAPI, federated_optimizer="fedbuff",
        async_base_optimizer="scaffold")
    assert resumed._version == CFG["comm_round"]


def test_dense_checkpoint_restores_into_a_store_run(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    dense = port(FedAvgAPI, base_args(**{**CFG, "comm_round": 3},
                                      federated_optimizer="SCAFFOLD",
                                      checkpoint_dir=ckpt))
    dense.train()
    store = port(FedAvgAPI, base_args(**CFG, federated_optimizer="SCAFFOLD",
                                      checkpoint_dir=ckpt,
                                      client_store=True))
    assert store.maybe_resume() == 3
    rows = store._store.gather(np.arange(12))
    for k, v in dense.client_table.items():
        np.testing.assert_array_equal(v.numpy(), rows[k], err_msg=k)


def test_state_flattening_and_refusals(tmp_path):
    api = port(FedAvgAPI, base_args(**CFG, federated_optimizer="FedOpt"))
    flat = state_to_flat(api.state)
    assert "round_idx" in flat and any(k.startswith("opt_state/")
                                       for k in flat)
    back = state_from_flat(flat, api.state)
    assert back.round_idx == api.state.round_idx
    for k, v in api.state.global_params.items():
        assert back.global_params[k] is flat[f"global_params/{k}"]
    # checkpoint_codec="wire" selects the fedwire checkpointer
    wired = port(FedAvgAPI, base_args(**CFG, checkpoint_dir=str(tmp_path),
                                      checkpoint_codec="wire"))
    assert isinstance(wired._checkpointer(), WireCheckpointer)
    ck = RoundCheckpointer(str(tmp_path / "x"))
    with pytest.raises(NotImplementedError, match="client store"):
        ck.save(1, {"w": torch.zeros(1)}, client_state=[1, 2])
