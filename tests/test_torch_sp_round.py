"""The port's sp FedAvg rounds against the JAX package's on the CPU.

Both engines start from the same weights (the JAX init carried across by
``models/convert.py``) and see the same cohorts, batch schedules and step
masks (bitwise-equal host streams), so their rounds differ only by f32
rounding.  Tolerance: global params, per-round ``train_loss`` and
``evaluate()`` loss/accuracy within 1e-5 (absolute) after every round.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from fedml_tpu import data as j_data
from fedml_tpu import model as j_model
from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI

import fedml_tpu_torch
from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.core import federated as t_federated
from fedml_tpu_torch.device import get_device
from fedml_tpu_torch.ml.trainer.local_trainer import LocalTrainer
from fedml_tpu_torch.models.convert import from_flax
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvgAPI

TOL = 1e-5
_DIGITS = str(pathlib.Path(__file__).resolve().parents[1] / "data_shards")


def tiny(**over):
    """``tests/test_e2e_sp.py``'s ``tiny_args`` on the generic synthetic
    dataset, with no data cache."""
    cfg = dict(dataset="synthetic", num_classes=10, input_shape=(28, 28, 1),
               model="lr", client_num_in_total=8, client_num_per_round=4,
               comm_round=4, epochs=1, batch_size=16, learning_rate=0.1,
               train_size=512, test_size=256, frequency_of_the_test=2,
               random_seed=42, data_cache_dir="")
    cfg.update(over)
    return cfg


def _pair(cfg, mode="vmap"):
    jargs = j_arguments().update(**cfg)
    jds, jout = j_data.load(jargs)
    japi = JFedAvgAPI(jargs, None, jds, j_model.create(jargs, jout),
                      client_mode=mode)
    targs = t_arguments().update(**cfg)
    tds, tout = t_data.load(targs)
    tmodel = t_model.create(targs, tout)
    tapi = TFedAvgAPI(targs, "cpu", tds, tmodel, client_mode=mode)
    start = jax.device_get(japi.state.global_params)
    tapi.state = tapi.state.replace(
        global_params=from_flax(start, tmodel, device="cpu"))
    return japi, tapi


def _params_close(japi, tapi):
    ref = from_flax(jax.device_get(japi.state.global_params), tapi.model,
                    device="cpu")
    for k, v in tapi.state.global_params.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("model,over", [
    ("lr", {}),
    ("lr", dict(partition_method="hetero", partition_alpha=0.3,
                client_num_per_round=5, momentum=0.9)),
    ("lr", dict(partition_method="hetero", partition_alpha=0.3,
                client_optimizer="adam", learning_rate=0.01,
                clip_grad_norm=1.0)),
    ("cnn_web", dict(partition_method="hetero", partition_alpha=0.3,
                     input_shape=(12, 12, 1), train_size=256, test_size=64,
                     batch_size=8, learning_rate=0.05)),
])
def test_rounds_match_jax(model, over):
    """Rounds from the same weights: params, round loss and evaluation
    agree after each of three rounds.  The hetero splits are ragged, so
    clients run different step counts padded to a power of two and masked
    (``allocated_steps`` > ``total_steps``): with momentum, Adam and weight
    decay those padded steps must leave params and optimizer state as they
    were."""
    japi, tapi = _pair(tiny(model=model, comm_round=3, **over))
    ragged = False
    for r in range(3):
        jm = japi.train_one_round(r)
        tm = tapi.train_one_round(r)
        assert int(tm["allocated_steps"]) == int(jm["allocated_steps"])
        assert float(tm["total_steps"]) == float(jm["total_steps"])
        ragged |= float(tm["total_steps"]) < int(tm["allocated_steps"])
        assert abs(float(tm["train_loss"]) - float(jm["train_loss"])) < TOL
        _params_close(japi, tapi)
    jl, ja = japi.evaluate()
    tl, ta = tapi.evaluate()
    assert abs(tl - jl) < TOL and abs(ta - ja) < TOL
    if over.get("partition_method") == "hetero":
        assert ragged


@pytest.mark.parametrize("batch", [4, 20])
@pytest.mark.parametrize("model,over", [
    ("cnn_web", dict(input_shape=(28, 28, 1))),
    ("cnn_cifar", dict(dataset="cifar10", input_shape=None))])
def test_cnn_rounds_at_batches_4_and_20_match_jax(model, over, batch):
    """The CNNs pass their permuted NHWC view to the convolutions (the
    ResNets copy it to NCHW first: oneDNN's channels-last backward corrupted
    the heap there at batches 4 and 20).  At those batches two CNN rounds
    run and match the JAX rounds (1e-5).  At lr 0.01: at 0.05 the 25
    steps of batch 4 of ``cnn_cifar`` amplify f32 rounding from 1.0e-5
    after one round to 3.7e-3 after two, with or without a contiguous
    NCHW copy of the input (the two read the same to the last bit)."""
    japi, tapi = _pair(tiny(model=model, batch_size=batch, comm_round=2,
                            train_size=200, test_size=40,
                            learning_rate=0.01, **over))
    for r in range(2):
        jm, tm = japi.train_one_round(r), tapi.train_one_round(r)
        assert abs(float(tm["train_loss"]) - float(jm["train_loss"])) < TOL
    _params_close(japi, tapi)


def test_default_arguments_are_the_reference_s():
    """``load_arguments()`` holds the JAX package's defaults on every key
    both packages define (so ``run_simulation()`` with no args is FedAvg
    ``lr`` on ``synthetic_mnist`` in both), apart from the recorded
    divergence ``data_cache_dir=""``."""
    from fedml_tpu.arguments import _DEFAULTS as J_DEFAULTS

    port = vars(t_arguments())
    shared = sorted(set(port) & set(J_DEFAULTS))
    assert len(shared) >= 20
    differ = {k: (port[k], J_DEFAULTS[k]) for k in shared
              if port[k] != J_DEFAULTS[k]}
    assert differ == {"data_cache_dir": ("", J_DEFAULTS["data_cache_dir"])}
    assert (port["model"], port["dataset"]) == ("lr", "synthetic_mnist")


def test_train_records_match_jax():
    """``train()`` end to end: the same metrics-history records (round,
    train_loss, test metrics on log rounds, provenance) as the JAX run."""
    japi, tapi = _pair(tiny())
    japi.train()
    tapi.train()
    assert len(tapi.metrics_history) == len(japi.metrics_history) == 4
    for t, j in zip(tapi.metrics_history, japi.metrics_history):
        assert set(t) == set(j)
        assert t["round"] == j["round"]
        assert t["dataset_provenance"] == j["dataset_provenance"]
        for key in ("train_loss", "test_loss", "test_acc"):
            if key in j:
                assert abs(t[key] - j[key]) < TOL, (key, t, j)
    _params_close(japi, tapi)


def test_canonical_digits_lr_curve_matches_jax():
    """The reference's canonical sp config scaled to the real sklearn
    digits (``BASELINE.md``: LR, 100 clients, 10 a round, batch 10, lr
    0.03, Dirichlet α 0.5, 200 rounds): from the same weights the port's
    test curve is the JAX engine's (1e-5), 0.800 at round 200."""
    pytest.importorskip("sklearn")
    japi, tapi = _pair(dict(
        dataset="digits", model="lr", input_shape=(8, 8, 1),
        client_num_in_total=100, client_num_per_round=10, comm_round=200,
        batch_size=10, learning_rate=0.03, partition_method="hetero",
        partition_alpha=0.5, frequency_of_the_test=50, random_seed=0,
        data_cache_dir=""))
    japi.train()
    tapi.train()
    curve = [(t["round"], t["test_acc"], j["test_acc"])
             for t, j in zip(tapi.metrics_history, japi.metrics_history)
             if "test_acc" in j]
    assert [c[0] for c in curve] == [0, 50, 100, 150, 199]
    assert all(abs(t - j) < TOL for _, t, j in curve), curve
    assert abs(curve[-1][1] - 0.8) < 1e-6, curve


def test_host_staged_rounds_match_jax():
    """``device_data=False`` ships the cohort's batches instead of index
    tensors: same rounds."""
    japi, tapi = _pair(tiny(device_data=False, comm_round=2,
                            partition_method="hetero", partition_alpha=0.3))
    for r in range(2):
        jm = japi.train_one_round(r)
        tm = tapi.train_one_round(r)
        assert abs(float(tm["train_loss"]) - float(jm["train_loss"])) < TOL
    _params_close(japi, tapi)


def _port_api(mode, **over):
    args = t_arguments().update(**tiny(**over))
    ds, out = t_data.load(args)
    return TFedAvgAPI(args, "cpu", ds, t_model.create(args, out),
                      client_mode=mode)


@pytest.mark.parametrize("model", ["lr", "cnn"])
def test_scan_and_vmap_agree(model):
    """Mirrors ``test_sp_scan_vmap_agree``: the two client modes give the
    same global params (1e-5); the CNN's dropout masks are drawn once per
    round outside ``vmap``, so they agree there too."""
    over = dict(comm_round=2)
    if model == "cnn":
        over.update(dataset="digits", input_shape=(8, 8, 1), model="cnn",
                    data_cache_dir=_DIGITS, batch_size=16,
                    client_num_per_round=3, learning_rate=0.05)
    outs = []
    for mode in ("scan", "vmap"):
        api = _port_api(mode, **over)
        api.train()
        outs.append(api.state.global_params)
    for k in outs[0]:
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=0, atol=TOL)


def _evaluate(args, params):
    ds, out = t_data.load(args)
    trainer = LocalTrainer(t_model.create(args, out), args)
    return trainer.evaluate(params, *ds.test_batches())


def test_sp_fedavg_learns():
    """Mirrors ``test_e2e_sp.py::test_sp_fedavg_learns`` through
    ``run_simulation``: accuracy up by more than 0.1, loss down."""
    args = t_arguments().update(**tiny())
    start = _port_api("vmap").state.global_params   # the seed's init
    loss0, acc0 = _evaluate(args, start)
    params = fedml_tpu_torch.run_simulation(backend="sp", args=args,
                                            device="cpu")
    loss1, acc1 = _evaluate(args, params)
    assert acc1 > acc0 + 0.1, (acc0, acc1)
    assert loss1 < loss0


def test_digits_cnn_learns_on_real_bytes():
    """Mirrors ``test_datasets_ext.py``'s real-digits CNN run: the LEAF
    shard's 15 users (a round-robin split), 5 a round, 8 rounds, through
    ``run_simulation``; test accuracy above 0.6 (the JAX test's bar)."""
    args = t_arguments().update(
        dataset="digits", model="cnn", input_shape=(8, 8, 1),
        data_cache_dir=_DIGITS, client_num_in_total=15,
        client_num_per_round=5, comm_round=8, epochs=1, batch_size=16,
        learning_rate=0.05, frequency_of_the_test=10 ** 9, random_seed=0)
    params = fedml_tpu_torch.run_simulation(backend="sp", args=args,
                                            device="cpu")
    _, acc = _evaluate(args, params)
    assert acc > 0.6, acc


@pytest.mark.parametrize("flag,value", [
    ("trace", True), ("health", True), ("metrics_port", 0),
    ("collective_precision", "bf16")])
def test_unported_options_raise_by_name(flag, value):
    """What stays unported of each option raises naming it.  The quantized
    collective layer runs on the sp engine; its combination with
    round_block fusion does not.  The obs options run on the sp engine
    (``tests/test_torch_obs_*.py`` hold them to the JAX package): what
    stays refused of them is ``trace_device`` where the probe cannot split
    the round (a population), ``health`` on an engine whose rounds return
    no per-client lanes (the hierarchical engine) and ``metrics_port`` on
    the decentralized engine (the serving server's runs,
    ``tests/test_torch_serving_obs.py``)."""
    from fedml_tpu_torch import obs
    if flag == "collective_precision":
        with pytest.raises(NotImplementedError, match=flag):
            _port_api("vmap", **{flag: value}, round_block=2)
        return
    try:
        api = _port_api("vmap", **{flag: value})
        if api.metrics_server is not None:
            api.metrics_server.close()
        with pytest.raises(NotImplementedError, match=flag):
            if flag == "trace":
                _port_api("vmap", trace=True, trace_device=True,
                          population=2)
            elif flag == "health":
                from fedml_tpu_torch.simulation.sp.hierarchical_fl import \
                    HierarchicalFedAvgAPI
                args = t_arguments().update(**tiny(
                    health=True, federated_optimizer="HierarchicalFL",
                    group_num=2, group_comm_round=1))
                ds, out = t_data.load(args)
                HierarchicalFedAvgAPI(args, "cpu", ds,
                                      t_model.create(args, out))
            else:
                from fedml_tpu_torch.runner import FedMLRunner
                args = t_arguments().update(**tiny(
                    metrics_port=0, federated_optimizer="dsgd",
                    topology="symmetric", topology_neighbors=2))
                ds, out = t_data.load(args)
                FedMLRunner(args, "cpu", ds, t_model.create(args, out))
    finally:
        obs.configure(enabled=False)
        obs.get_tracer().reset()


@pytest.mark.parametrize("over,what", [
    (dict(backend="mesh", mesh_data=2), "mesh"),
    (dict(backend="NCCL", mesh_data=2), "NCCL"),
    (dict(backend="MPI", mesh_data=2), "MPI"),
    pytest.param(dict(num_silos=2), None, id="over3-num_silos"),
    (dict(model="vit"), "vit"),
    (dict(dataset="cifar10", model="cnn_cifar", data_cache_dir="x"), None),
    (dict(dataset="imagenet"), "imagenet")])
def test_run_simulation_refuses_what_is_not_ported(over, what):
    """Unported backends, algorithms, models and datasets raise naming
    themselves; an absent cache directory falls back to synthetic data as
    in the JAX package (the cifar case runs).  The mesh backends run the
    2-D and 3-D layouts; a ``data`` factor is refused, naming the
    backend.  ``num_silos > 1`` runs (the two-tier silo aggregation,
    ``store/hierarchy.py``)."""
    args = t_arguments().update(**tiny(comm_round=1, **over))
    backend = over.get("backend", "sp")
    if what is None:
        args.update(train_size=64, test_size=16)
        fedml_tpu_torch.run_simulation(backend=backend, args=args,
                                       device="cpu")
        return
    with pytest.raises(NotImplementedError, match=what):
        fedml_tpu_torch.run_simulation(backend=backend, args=args,
                                       device="cpu")


def test_only_the_fedavg_family_runs():
    """The port's allow-list: every registered algorithm of the zoo in any
    case, ``fedbuff`` (the buffered-async engine's name) included; anything
    else refused as unknown."""
    zoo = ("fedavg", "fedavg_seq", "fedprox", "fedopt", "fedopt_seq",
           "scaffold", "feddyn", "fednova", "mime", "fedsgd", "qfedavg")
    for name in zoo:
        assert t_federated.check_algorithm(name.upper()) == name
        assert t_federated.has_spec(name)
    assert t_federated.check_algorithm("qFedAvg") == "qfedavg"
    assert t_federated.check_algorithm("FedBuff") == "fedbuff"
    with pytest.raises(ValueError, match="fedavgx"):
        t_federated.check_algorithm("fedavgx")


def test_get_device_needs_cuda_unless_cpu_is_asked(monkeypatch):
    """No fallback: without CUDA the card path raises; ``"cpu"`` is only
    taken when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = t_arguments()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_device(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fedml_tpu_torch.run_simulation(backend="sp",
                                       args=args.update(**tiny()))
    assert get_device(t_arguments().update(device="cpu")) == \
        torch.device("cpu") == get_device(args, "cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        get_device(t_arguments().update(device="tpu"))
