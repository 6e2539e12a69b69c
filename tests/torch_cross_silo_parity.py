"""Shared helpers of the port's cross-silo tests (``test_torch_cross_silo*
.py``): run one federation — a server and its silos as threads — in the
JAX package and in the port, the port starting from the JAX server's
initial weights (carried across by ``models/convert.py`` through
``FedMLAggregator.set_global_model_params``), and compare the final
params."""

import threading

import jax
import numpy as np

from fedml_tpu import data as j_data
from fedml_tpu import model as j_model
from fedml_tpu.arguments import load_arguments as j_arguments

from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.models.convert import from_flax

#: every thread join waits at most this long: a deadlock fails one test
JOIN_S = 60.0

#: tests/test_cross_silo.py's make_args (lr on synthetic 14×14, 2 silos)
LR = dict(dataset="synthetic", num_classes=10, input_shape=(14, 14, 1),
          train_size=512, test_size=128, model="lr", client_num_in_total=2,
          client_num_per_round=2, comm_round=3, epochs=1, batch_size=16,
          learning_rate=0.1, random_seed=11, client_id_list=[1, 2],
          frequency_of_the_test=1, data_cache_dir="")

#: a narrow FedNLP text transformer (dim 32, one layer), no dropout
TEXT = dict(dataset="20news", model="distilbert", seq_len=16,
            vocab_size=128, model_dim=32, model_layers=1, model_heads=2,
            model_ffn_dim=64, text_class_signal=0.5, text_keyword_width=1.0,
            train_size=240, test_size=60, client_num_in_total=2,
            client_num_per_round=2, comm_round=2, epochs=1, batch_size=20,
            learning_rate=0.1, partition_method="homo", random_seed=0,
            client_id_list=[1, 2], frequency_of_the_test=1, data_cache_dir="")

PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4


def args_for(pkg, cfg, backend, rank, run_id, **over):
    load = j_arguments if pkg == "jax" else t_arguments
    a = load().update(**cfg)
    a.update(training_type="cross_silo", backend=backend, rank=rank,
             run_id=run_id, role="server" if rank == 0 else "client")
    return a.update(**over)


def run_threads(server_fn, client_fn, ranks):
    """Start the server and the silos as threads, join each within
    ``JOIN_S`` and re-raise the first failure."""
    errors = []

    def guard(fn, *a):
        try:
            fn(*a)
        except BaseException as e:   # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=guard, args=(server_fn,),
                                daemon=True)]
    threads += [threading.Thread(target=guard, args=(client_fn, r),
                                 daemon=True) for r in ranks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads), "federation deadlocked"


def jax_federation(cfg, backend, run_id, agg_factory=None, **over):
    """The JAX package's federation; returns the server's initial and
    final params, its last eval accuracy and the server object."""
    from fedml_tpu.cross_silo.client import Client
    from fedml_tpu.cross_silo.server import Server

    out = {}
    ranks = list(range(1, len(cfg["client_id_list"]) + 1))

    def server():
        a = args_for("jax", cfg, backend, 0, run_id, **over)
        ds, n_out = j_data.load(a)
        m = j_model.create(a, n_out)
        srv = Server(a, None, ds, m,
                     agg_factory(m, a) if agg_factory else None)
        out["init"] = jax.device_get(srv.aggregator.get_global_model_params())
        out["params"] = jax.device_get(srv.run())
        out["acc"] = srv.aggregator.test_on_server_for_all_clients(
            int(a.comm_round) - 1)
        out["server"] = srv

    def client(rank):
        a = args_for("jax", cfg, backend, rank, run_id, **over)
        ds, n_out = j_data.load(a)
        Client(a, None, ds, j_model.create(a, n_out)).run()

    run_threads(server, client, ranks)
    return out


def port_federation(cfg, backend, run_id, init=None, agg_factory=None,
                    device="cpu", **over):
    """The port's federation on ``device``, from the flax ``init`` params
    when given; returns the final params, the last eval accuracy, the
    server's model and the server and client objects."""
    from fedml_tpu_torch.cross_silo.client import Client
    from fedml_tpu_torch.cross_silo.server import Server

    out = {"clients": {}}
    ranks = list(range(1, len(cfg["client_id_list"]) + 1))

    def server():
        a = args_for("port", cfg, backend, 0, run_id, **over)
        ds, n_out = t_data.load(a)
        m = t_model.create(a, n_out)
        srv = Server(a, device, ds, m,
                     agg_factory(m, a) if agg_factory else None)
        if init is not None:
            srv.aggregator.set_global_model_params(
                from_flax(init, m, device=device))
        out["model"] = m
        out["params"] = srv.run()
        out["acc"] = srv.aggregator.test_on_server_for_all_clients(
            int(a.comm_round) - 1)
        out["server"] = srv

    def client(rank):
        a = args_for("port", cfg, backend, rank, run_id, **over)
        ds, n_out = t_data.load(a)
        c = Client(a, device, ds, t_model.create(a, n_out))
        out["clients"][rank] = c
        c.run()

    run_threads(server, client, ranks)
    return out


def assert_params_close(port_out, jax_params, atol=PARAM_ATOL,
                        rtol=PARAM_RTOL):
    ref = from_flax(jax_params, port_out["model"], device="cpu")
    got = port_out["params"]
    assert set(got) == set(ref)
    for k, v in got.items():
        np.testing.assert_allclose(v.detach().cpu().numpy(), ref[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def assert_params_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k].detach().cpu().numpy(),
                              b[k].detach().cpu().numpy()), k
