"""The port's two-tier silo aggregation (``store/hierarchy.py``) against
the JAX package's, and its multi-rank driver against the in-process one.

- ``HierarchicalSiloAPI`` ≡ the JAX one (FedAvg, FedOpt, q-FedAvg) from
  the same weights within the reassociation bound the JAX package pins
  (2e-5), and SCAFFOLD's partials through the int8 wire in-process;
- two-tier ≡ flat in the port (dropout masks drawn once for the cohort
  and sliced per silo), wire fp32 ≡ wire off bitwise, and
  ``run_simulation`` selects the class on ``num_silos > 1``;
- ``run_silo_federation`` with a server and 2 silos in threads over the
  ``local`` backend: bitwise the in-process run at wire fp32, within the
  int8 bound with ``wire_overlap``, chunked frames and reliable delivery,
  a quorum close with a crashed silo, and stateful algorithms refused.
"""

import threading

import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.core import federated
from fedml_tpu_torch.core.distributed.communication.fault_injection import (
    SiloCrashed)
from fedml_tpu_torch.core.distributed.communication.local import (
    local_comm_manager)
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI
from fedml_tpu_torch.store.hierarchy import (HierarchicalSiloAPI,
                                             run_silo_federation)

from .torch_sp_parity import build, port_tree, state_close, tiny

#: the JAX package's reassociation bound of two-tier against flat
#: aggregation (tests/test_client_store.py) and its PR 5 int8 loss bound
#: (tests/test_wire.py)
REASSOC_TOL = 2e-5
INT8_LOSS_ATOL = 1e-2
#: tiny models only quantize below the default 256-element block
WIRE_BLOCK = 16
ROUNDS = 4
JOIN_S = 60.0

#: tests/test_wire.py's two-tier harness config
TWO_TIER = dict(dataset="synthetic", num_classes=4, input_shape=(8,),
                train_size=96, test_size=32, model="lr",
                client_num_in_total=8, client_num_per_round=4,
                comm_round=ROUNDS, epochs=1, batch_size=8,
                learning_rate=0.1, random_seed=7, partition_method="homo",
                num_silos=2, frequency_of_the_test=10 ** 9,
                data_cache_dir="", comm_recv_timeout_s=30.0)


def port_api(cls, **over):
    args = fedml_tpu_torch.init(
        fedml_tpu_torch.load_arguments().update(**dict(TWO_TIER, **over)),
        should_init_logs=False)
    ds, out = t_data.load(args)
    return cls(args, "cpu", ds, t_model.create(args, out))


def losses_of(api, rounds=ROUNDS):
    return [float(api.train_one_round(r)["train_loss"])
            for r in range(rounds)]


@pytest.mark.parametrize("alg,over", [
    ("FedAvg", {}),
    ("FedOpt", dict(server_optimizer="adam", server_lr=0.05)),
    ("qFedAvg", {})])
def test_silo_api_matches_jax(alg, over):
    from fedml_tpu.store.hierarchy import HierarchicalSiloAPI as JaxSilo

    ja, ta, tm = build(tiny(num_silos=2, federated_optimizer=alg, **over),
                       JaxSilo, HierarchicalSiloAPI)
    ta.reset_params(port_tree(ja.state.global_params, tm))
    for r in range(2):
        jl = float(ja.train_one_round(r)["train_loss"])
        tl = float(ta.train_one_round(r)["train_loss"])
        assert abs(jl - tl) < REASSOC_TOL, (alg, r, jl, tl)
    state_close(ja, ta, tm, tol=REASSOC_TOL)


def test_scaffold_inprocess_int8_wire_matches_jax():
    """SCAFFOLD's partials through the int8 wire in-process (the stateful
    algorithm the multi-rank driver refuses): quantization engaged within
    the int8 bound, as the JAX package pins it, and the port's int8 run
    holds the JAX package's own within that bound (the port's numerators
    differ from JAX's by reassociation, so an element of the state may
    round to the next int8 code, a step the losses do not see at 2e-5)."""
    from fedml_tpu.store.hierarchy import HierarchicalSiloAPI as JaxSilo

    cfg = tiny(num_silos=2, federated_optimizer="SCAFFOLD")
    runs = {}
    for prec in ("off", "int8"):
        ja, ta, tm = build(dict(cfg, wire_precision=prec,
                                wire_block=WIRE_BLOCK), JaxSilo,
                           HierarchicalSiloAPI)
        ta.reset_params(port_tree(ja.state.global_params, tm))
        runs[prec] = (losses_of(ja, 3), losses_of(ta, 3))
    (j_off, t_off), (j_q, t_q) = runs["off"], runs["int8"]
    assert np.max(np.abs(np.subtract(j_off, t_off))) < REASSOC_TOL
    assert np.max(np.abs(np.subtract(j_q, t_q))) < REASSOC_TOL
    d = np.max(np.abs(np.subtract(t_off, t_q)))
    assert 0 < d < INT8_LOSS_ATOL, d


def test_two_tier_equals_flat_with_dropout():
    """The two-tier round ≡ the flat round up to reassociation on the
    dropout CNN: each silo's clients see the masks the flat round draws."""
    over = dict(model="cnn", dataset="synthetic", num_classes=10,
                input_shape=(12, 12, 1), train_size=192, test_size=32,
                batch_size=8, learning_rate=0.05, num_silos=2)
    silo, flat = port_api(HierarchicalSiloAPI, **over), \
        port_api(FedAvgAPI, **over)
    assert silo.model.has_dropout
    flat.reset_params(silo.state.global_params)
    ls, lf = losses_of(silo, 2), losses_of(flat, 2)
    assert np.max(np.abs(np.subtract(ls, lf))) < REASSOC_TOL, (ls, lf)
    for k, v in silo.state.global_params.items():
        torch.testing.assert_close(v, flat.state.global_params[k], rtol=0,
                                   atol=REASSOC_TOL)


def test_wire_fp32_is_bitwise_wire_off_and_run_simulation_selects():
    off = port_api(HierarchicalSiloAPI)
    fp32 = port_api(HierarchicalSiloAPI, wire_precision="fp32",
                    wire_block=WIRE_BLOCK)
    assert losses_of(off) == losses_of(fp32)
    for k, v in off.state.global_params.items():
        assert torch.equal(v, fp32.state.global_params[k])

    args = fedml_tpu_torch.load_arguments().update(
        **dict(TWO_TIER, comm_round=1, device="cpu"))
    from fedml_tpu_torch.simulation.simulator import SimulatorSingleProcess
    ds, out = t_data.load(args)
    sim = SimulatorSingleProcess(args, "cpu", ds, t_model.create(args, out))
    assert isinstance(sim.fl_trainer, HierarchicalSiloAPI)
    sim.run()
    assert len(sim.fl_trainer.metrics_history) == 1


# -- the multi-rank driver ----------------------------------------------------

def federate(run_id, crash=None, **over):
    """A server and ``num_silos`` silos as threads over ``local``; returns
    the server's history and its API.  ``crash``: a silo rank whose
    SiloCrashed is expected."""
    out, errors = {}, []

    def run(rank):
        try:
            api_args = fedml_tpu_torch.init(
                fedml_tpu_torch.load_arguments().update(**dict(
                    TWO_TIER, rank=rank, backend="local", run_id=run_id,
                    **over)), should_init_logs=False)
            ds, n = t_data.load(api_args)
            model = t_model.create(api_args, n)
            api = HierarchicalSiloAPI(api_args, "cpu", ds, model)
            out[rank] = run_silo_federation(api_args, "cpu", ds, model,
                                            api=api)
            out[f"api{rank}"] = api
        except SiloCrashed:
            if rank != crash:
                raise
        except BaseException as e:   # noqa: BLE001 — surfaced below
            errors.append(e)

    silos = int(over.get("num_silos", TWO_TIER["num_silos"]))
    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(silos, -1, -1)]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join(timeout=JOIN_S)
    finally:
        local_comm_manager.reset_run(run_id)
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads), "federation deadlocked"
    return out[0], out["api0"]


@pytest.fixture(scope="module")
def inprocess():
    api = port_api(HierarchicalSiloAPI)
    return losses_of(api), api.state.global_params


def test_silo_federation_fp32_is_bitwise_inprocess(inprocess):
    hist, api = federate("t_silo_fp32", wire_precision="fp32",
                         wire_block=WIRE_BLOCK)
    assert [h["train_loss"] for h in hist] == inprocess[0]
    assert [h["quorum"] for h in hist] == [2] * ROUNDS
    for k, v in inprocess[1].items():
        assert torch.equal(api.state.global_params[k], v), k
    assert list(api.state.global_params) == list(inprocess[1])


def test_silo_federation_int8_overlap_chunks_reliable(inprocess):
    hist, _ = federate("t_silo_int8", wire_precision="int8",
                       wire_block=WIRE_BLOCK, wire_overlap=True,
                       wire_chunk_bytes=256, reliable_delivery=True,
                       retry_base_s=0.05, retry_deadline_s=20.0)
    d = np.max(np.abs(np.subtract([h["train_loss"] for h in hist],
                                  inprocess[0])))
    assert 0 < d < INT8_LOSS_ATOL, d


def test_quorum_close_with_a_crashed_silo():
    """Silo 2 dies on receipt of round 1's dispatch; rounds 1.. close at
    the deadline with silo 1's partial padded by a zero partial, bitwise
    the in-process combine of that one partial."""
    hist, api = federate("t_silo_crash", crash=2, quorum=1,
                         quorum_deadline_s=0.3, comm_round=3,
                         chaos_crash_rank=2, chaos_crash_round=1,
                         chaos_crash_mode="raise")
    assert [h["quorum"] for h in hist] == [2, 1, 1]
    ref = port_api(HierarchicalSiloAPI, comm_round=3)
    want = [float(ref.train_one_round(0)["train_loss"])]
    for r in (1, 2):
        partial, w, lw, _s, _c = ref.silo_partial(r, 0)
        ref.apply_partials([partial, federated.zero_like_partial(partial)])
        ref._staged_round = None
        want.append(float(lw / w))
    assert [h["train_loss"] for h in hist] == want
    for k, v in ref.state.global_params.items():
        assert torch.equal(api.state.global_params[k], v), k


def test_stateful_algorithms_are_refused():
    args = fedml_tpu_torch.load_arguments().update(
        **dict(TWO_TIER, federated_optimizer="SCAFFOLD", rank=1,
               backend="local", run_id="t_silo_refuse"))
    ds, n = t_data.load(args)
    with pytest.raises(ValueError, match="stateless-client"):
        run_silo_federation(args, "cpu", ds, t_model.create(args, n))


def test_wal_journals_the_digest_of_the_shipped_state(tmp_path):
    """The combine tier with ``checkpoint_dir`` and wire checkpoints: the
    WAL entry of every applied round carries the crc32 of the wire-fp32
    payload of the state it shipped that round (the in-process run's state
    before the round, encoded afresh: fp32 carries no residual), and the
    wire checkpoint holds the final state."""
    import zlib

    from fedml_tpu_torch.core import wire
    from fedml_tpu_torch.core.checkpoint import WireCheckpointer
    from fedml_tpu_torch.core.distributed.communication.message import (
        encode_tree)
    from fedml_tpu_torch.core.distributed.reliability import RoundWAL

    hist, api = federate("t_silo_wal", wire_precision="fp32",
                         wire_block=WIRE_BLOCK,
                         checkpoint_dir=str(tmp_path),
                         checkpoint_codec="wire")
    ref = port_api(HierarchicalSiloAPI)
    codec = wire.WireCodec("fp32", WIRE_BLOCK, ref.layout)
    want = []
    for r in range(ROUNDS):
        payload, _ = codec.encode(wire.state_tree(ref.state))
        want.append(f"{zlib.crc32(encode_tree(payload)):08x}")
        ref.train_one_round(r)
    entries = RoundWAL(str(tmp_path)).entries()
    assert [e["round"] for e in entries] == list(range(ROUNDS))
    assert [e["state_digest"] for e in entries] == want
    final = WireCheckpointer(str(tmp_path), layout=ref.layout).restore_state()
    for k, v in api.state.global_params.items():
        assert torch.equal(final[f"global_params/{k}"], v), k
