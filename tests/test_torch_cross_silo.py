"""The port's cross-silo federation against the JAX package's, on the CPU:
a server and 2 silos as threads, the port starting from the JAX server's
initial weights.

- ``tests/test_cross_silo.py``'s ``lr`` federation over ``local``: final
  params within atol 2e-5 / rtol 1e-4 of the JAX run's, the server's eval
  accuracy equal; over ``filestore`` and ``MQTT_S3`` (the in-repo broker
  on an ephemeral port) bitwise the port's ``local`` run.
- Chaos: ``tests/test_chaos.py``'s dup/delay settings with
  ``reliable_delivery`` and chunked frames give the clean run bitwise; a
  clipped text run (Adam, clip 1.0) through 4 KiB frames is bitwise its
  by-reference run (a decoded params dict is put back in model order).
- A narrow text transformer (dim 32, one layer; the kernels' plain
  versions on the CPU): within 1e-4 of the JAX run.
- A user ``ServerAggregator``: its hooks run in the JAX order, once each a
  round, and give the JAX run's result.
- The cross-silo and sp engines agree on the dropout-free ``lr`` run, in
  the JAX package and in the port (what lets ``chip_smoke.py`` hold a
  cross-silo run against the sp engine).
"""

import numpy as np
import pytest
import torch

from fedml_tpu_torch.core import tree as tree_util

from .torch_cross_silo_parity import (LR, TEXT, args_for, assert_params_close,
                                      assert_params_equal, jax_federation,
                                      port_federation)

#: tests/test_chaos.py::test_cross_silo_survives_dup_and_delay_chaos
CHAOS = dict(chaos_seed=7, chaos_dup_prob=0.3, chaos_delay_prob=0.5,
             chaos_max_delay_s=0.03)
TEXT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread per process avoids oversubscribing
    the cores shared by three federation threads and other test
    workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_lr():
    return jax_federation(LR, "local", "tj_lr")


@pytest.fixture(scope="module")
def port_lr(jax_lr):
    return port_federation(LR, "local", "tp_lr", init=jax_lr["init"])


def test_lr_federation_matches_jax(jax_lr, port_lr):
    assert_params_close(port_lr, jax_lr["params"])
    assert port_lr["acc"] == jax_lr["acc"] and port_lr["acc"] > 0.5
    # every silo ran its local pass each round and timed it
    for c in port_lr["clients"].values():
        t = c.client_manager.timings
        assert [r["round"] for r in t] == [0, 1, 2]
        assert all(r["local_pass_s"] > 0 for r in t)
        assert all(r["upload_to_sync_s"] is not None for r in t)


@pytest.mark.parametrize("backend", ["filestore", "MQTT_S3"])
def test_wan_backends_give_the_local_result(backend, jax_lr, port_lr,
                                            tmp_path):
    from fedml_tpu_torch.core.distributed.communication.mqtt.mini_broker \
        import MiniMqttBroker
    from fedml_tpu_torch.core.distributed.communication.mqtt \
        .mqtt_s3_comm_manager import preregister_session

    broker = MiniMqttBroker().start()
    try:
        over = dict(filestore_dir=str(tmp_path / "fs"),
                    store_dir=str(tmp_path / "store"),
                    mqtt_config={"host": "127.0.0.1", "port": broker.port})
        run_id = f"tp_{backend}"
        if backend == "MQTT_S3":
            # the server's persistent session exists before any silo
            # publishes its ONLINE status
            preregister_session(args_for("port", LR, backend, 0, run_id,
                                         **over), 0, 3)
        out = port_federation(LR, backend, run_id, init=jax_lr["init"],
                              **over)
    finally:
        broker.stop()
    assert_params_equal(out["params"], port_lr["params"])
    assert out["acc"] == jax_lr["acc"]


def test_chaos_with_reliable_delivery_and_chunks_gives_the_clean_result(
        jax_lr, port_lr):
    """Duplicated and delayed (reordered) messages, acked and retransmitted
    by the reliability layer and split into 2 KiB frames: the federation
    ends bitwise where the clean one does."""
    out = port_federation(LR, "local", "tp_chaos", init=jax_lr["init"],
                          reliable_delivery=True,
                          reliable_types=[1, 2, 3, 5, 7],
                          wire_chunk_bytes=2048, **CHAOS)
    assert_params_equal(out["params"], port_lr["params"])
    assert out["acc"] == jax_lr["acc"]
    from fedml_tpu_torch.core.distributed.chunking import find_chunking
    from fedml_tpu_torch.core.distributed.reliability import find_reliable
    com = out["server"].server_manager.com_manager
    assert find_chunking(com).stats["reassembled"] >= 6
    assert find_reliable(com).stats["acks_sent"] > 0


def test_chaos_alone_gives_the_clean_result(jax_lr, port_lr):
    """The JAX test's dup/delay chaos without the reliability layer: the
    stale-round guard and idempotent uploads carry the run to the clean
    params."""
    out = port_federation(LR, "local", "tp_chaos_raw", init=jax_lr["init"],
                          **CHAOS)
    assert_params_equal(out["params"], port_lr["params"])


def test_text_transformer_federation_matches_jax():
    jx = jax_federation(TEXT, "local", "tj_text")
    pt = port_federation(TEXT, "local", "tp_text", init=jx["init"])
    assert_params_close(pt, jx["params"], atol=TEXT_TOL, rtol=0)
    assert pt["acc"] == jx["acc"]


def _hook_aggregator(pkg, calls):
    if pkg == "jax":
        from fedml_tpu.core import tree as tu
        from fedml_tpu.core.alg_frame.server_aggregator import \
            ServerAggregator
    else:
        from fedml_tpu_torch.core.alg_frame.server_aggregator import \
            ServerAggregator
        tu = tree_util

    class MyAgg(ServerAggregator):
        def get_model_params(self):
            return self._params

        def set_model_params(self, p):
            self._params = p

        def on_before_aggregation(self, raw_list):
            calls.append("before")
            return super().on_before_aggregation(raw_list)

        def aggregate(self, raw_list):
            calls.append("aggregate")
            return tu.weighted_average([p for _, p in raw_list],
                                       [n for n, _ in raw_list])

        def on_after_aggregation(self, agg):
            calls.append("after")
            return super().on_after_aggregation(agg)

        def test(self, test_data, device, args):
            return None

    return MyAgg


def test_user_server_aggregator_hooks_run_in_the_jax_order():
    jcalls, pcalls = [], []
    jx = jax_federation(LR, "local", "tj_ua",
                        agg_factory=_hook_aggregator("jax", jcalls))
    pt = port_federation(LR, "local", "tp_ua", init=jx["init"],
                         agg_factory=_hook_aggregator("port", pcalls))
    assert pcalls == jcalls == ["before", "aggregate", "after"] * 3
    assert_params_close(pt, jx["params"])
    assert pt["acc"] == jx["acc"]


def test_cross_silo_and_sp_engines_agree_without_dropout(jax_lr, port_lr):
    """``lr`` (no dropout): the sp engine over the same two clients, from
    the same weights, ends where the cross-silo federation does — in the
    JAX package and in the port."""
    from fedml_tpu import data as j_data, model as j_model
    from fedml_tpu.arguments import load_arguments as j_arguments
    from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvg

    from fedml_tpu_torch import data as t_data, model as t_model
    from fedml_tpu_torch.arguments import load_arguments as t_arguments
    from fedml_tpu_torch.models.convert import from_flax
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvg

    import jax

    ja = j_arguments().update(**LR)
    jds, jo = j_data.load(ja)
    japi = JFedAvg(ja, None, jds, j_model.create(ja, jo))
    japi.state = japi.state.replace(
        global_params=jax.tree_util.tree_map(np.asarray, jax_lr["init"]))
    ta = t_arguments().update(**LR)
    tds, to = t_data.load(ta)
    tm = t_model.create(ta, to)
    tapi = TFedAvg(ta, "cpu", tds, tm)
    tapi.state = tapi.state.replace(
        global_params=from_flax(jax_lr["init"], tm, device="cpu"))
    for r in range(LR["comm_round"]):
        japi.train_one_round(r)
        tapi.train_one_round(r)
    j_sp = jax.device_get(japi.state.global_params)
    for a, b in zip(jax.tree_util.tree_leaves(j_sp),
                    jax.tree_util.tree_leaves(jax_lr["params"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for k, v in tapi.state.global_params.items():
        np.testing.assert_allclose(v.numpy(), port_lr["params"][k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_framed_messages_keep_a_clipped_run_bitwise():
    """The codec writes a params dict's keys sorted (flax's layout); the
    silo and the server put a decoded dict back in the model's order, so
    a run that clips by the gradients' global norm (a sum over the dict in
    its order) gives the same bits through the codec as by reference."""
    cfg = dict(TEXT, client_optimizer="adam", learning_rate=1e-3,
               clip_grad_norm=1.0)
    clean = port_federation(cfg, "local", "tp_clip")
    framed = port_federation(cfg, "local", "tp_clip_frames",
                             wire_chunk_bytes=4096)
    assert_params_equal(framed["params"], clean["params"])
