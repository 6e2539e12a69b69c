"""The port's swept hyperparameters (``HParams``) and populations against
the JAX package's, on the CPU.  Mirrors the sp cases of
``tests/test_population.py`` (mesh and checkpoint cases stay unported).

A population of P runs P experiments in one round program:
``torch.func.vmap`` over the member axis of the server state, the client
table and the swept fields, outside the client map.  Both engines start
from the same weights (the JAX init carried across), so they see the same
cohorts, batch schedules and step masks.

Tolerances:

- each member against its own single-experiment run of the same package:
  atol 2e-5, rtol 1e-4 (the JAX test's bar: the member map batches the
  same arithmetic in another order);
- the port's population against the JAX package's: 1e-5 (absolute) on
  every member's params, losses and table rows; FedOpt's server Adam
  sweeps ``server_lr`` [0.03, 0.01] there (at 1.0 its normalised step
  turns f32 summation-order noise into steps of order ``server_lr``:
  ``tests/test_torch_sp_algorithms.py``);
- fused against unfused populations within the port: bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.core import federated as j_fed
from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI

from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.core import federated as fed
from fedml_tpu_torch.core import rng as t_rng
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvgAPI

from .torch_sp_parity import TOL, build, port, port_tree, tree_close


def pop_cfg(**over):
    """``tests/test_population.py``'s ``base_args``."""
    cfg = dict(dataset="synthetic", num_classes=10, input_shape=(14, 14, 1),
               train_size=768, test_size=192, model="lr",
               client_num_in_total=12, client_num_per_round=6, comm_round=3,
               epochs=1, batch_size=16, learning_rate=0.1, random_seed=11,
               partition_method="homo", frequency_of_the_test=10 ** 9,
               data_cache_dir="")
    cfg.update(over)
    return cfg


def make(**over):
    return port(TFedAvgAPI, t_arguments().update(**pop_cfg(**over)))


def pair(**over):
    """The JAX engine and the port's for ``pop_cfg(**over)``, the port
    started from the JAX weights (every member)."""
    japi, tapi, model = build(pop_cfg(**over), JFedAvgAPI, TFedAvgAPI)
    params = port_tree(j_fed.population_member(japi.state.global_params, 0)
                       if japi.population else japi.state.global_params,
                       model)
    if tapi.population:
        params = fed.stack_member_states(params, tapi.population.size)
    tapi.state = tapi.state.replace(global_params=params)
    return japi, tapi, model


def assert_close(a, b, atol=2e-5, rtol=1e-4, msg=""):
    for k, v in a.items():
        np.testing.assert_allclose(v.numpy(), b[k].numpy(), atol=atol,
                                   rtol=rtol, err_msg=f"{msg} {k}")


def members_close(japi, tapi, model, what="global_params"):
    """Every member's ``what`` (params or the client table) against the
    JAX package's, 1e-5."""
    jt, tt = getattr(japi.state, what, None), getattr(tapi.state, what, None)
    if what == "client_table":
        jt, tt = japi.client_table, tapi.client_table
    for m in range(tapi.population.size):
        jm = j_fed.population_member(jt, m)
        tm = fed.population_member(tt, m)
        if what == "client_table":
            for i in range(next(iter(tm.values())).shape[0]):
                tree_close({k: v[i] for k, v in tm.items()},
                           jax.tree_util.tree_map(lambda l: l[i], jm), model,
                           f"member {m} table row {i}")
        else:
            tree_close(tm, jm, model, f"member {m} {what}")


# -- hyperparameters ---------------------------------------------------------

def test_hparams_resolution_and_seed_fold():
    hp = fed.HParams(server_lr=torch.tensor(0.5), seed=torch.tensor(3))
    assert float(fed.resolve(hp, "server_lr", 1.0)) == 0.5
    assert fed.resolve(hp, "client_lr", 0.03) == 0.03
    assert fed.resolve(None, "server_lr", 1.0) == 1.0
    # lr ratio: None when not swept (bitwise default path), exact ratio else
    assert fed.lr_ratio(None, "client_lr", 0.1) is None
    assert fed.lr_ratio(fed.HParams(), "client_lr", 0.1) is None
    np.testing.assert_allclose(float(fed.lr_ratio(hp, "server_lr", 2.0)),
                               0.25)
    with pytest.raises(ValueError):
        fed.lr_ratio(hp, "server_lr", 0.0)
    gen = t_rng.round_key(t_rng.root_key(0), 4)
    g3 = fed.fold_seed(gen, hp)
    assert g3 is not gen and g3.initial_seed() != gen.initial_seed()
    assert not torch.equal(torch.rand(8, generator=g3),
                           torch.rand(8, generator=gen))
    assert fed.fold_seed(gen, None) is gen
    assert fed.fold_seed(gen, fed.HParams(client_lr=0.1)) is gen
    # a member's stream depends on its seed, not on how far the round's
    # generator was drawn; distinct seeds give distinct streams
    again = fed.fold_seed(t_rng.round_key(t_rng.root_key(0), 4), hp)
    assert again.initial_seed() == g3.initial_seed()
    seeds = {fed.fold_seed(gen, fed.HParams(seed=s)).initial_seed()
             for s in range(16)}
    assert len(seeds) == 16


def test_parse_population_grid_and_validation():
    args = t_arguments().update(**pop_cfg(
        population_axes={"server_lr": [1.0, 0.5], "seed": [0, 1, 2]}))
    pop = fed.parse_population(args)
    assert pop.size == 6
    assert pop.members[0] == {"server_lr": 1.0, "seed": 0}
    assert pop.members[-1] == {"server_lr": 0.5, "seed": 2}
    assert pop.hparams.server_lr.shape == (6,)
    assert pop.hparams.seed.dtype == torch.int32
    assert pop.hparams.client_lr is None
    # the same grid, members and dtypes as the JAX package's parse
    jpop = j_fed.parse_population(args)
    assert jpop.members == pop.members and jpop.axes == pop.axes
    np.testing.assert_array_equal(np.asarray(jpop.hparams.server_lr),
                                  pop.hparams.server_lr.numpy())

    assert fed.parse_population(t_arguments().update(**pop_cfg())) is None
    seeded = fed.parse_population(t_arguments().update(**pop_cfg(
        population=4)))
    assert seeded.size == 4 and tuple(
        int(s) for s in seeded.hparams.seed) == (0, 1, 2, 3)
    with pytest.raises(ValueError):
        fed.parse_population(t_arguments().update(**pop_cfg(
            population_axes={"bogus": [1]})))
    with pytest.raises(ValueError):
        fed.parse_population(t_arguments().update(**pop_cfg(
            population=3, population_axes={"seed": [0, 1]})))


def test_stack_and_member_round_trip_the_server_state():
    """``stack_member_states`` / ``population_member`` map every tensor of
    a ServerState (and of a table) and keep its host round counter."""
    api = make(federated_optimizer="FedOpt")
    st = fed.stack_member_states(api.state, 3)
    assert st.round_idx == api.state.round_idx
    assert st.opt_state["count"].shape == (3,)
    one = fed.population_member(st, 2)
    for k, v in api.state.global_params.items():
        assert torch.equal(one.global_params[k], v)
        assert st.global_params[k].shape == (3,) + v.shape


# -- populations -------------------------------------------------------------

POP_ALGS = [
    ("FedOpt", {"server_lr": [1.0, 0.3]}, {"server_lr": 1.0}),
    ("FedAvg", {"client_lr": [0.1, 0.04]}, {"learning_rate": 0.1}),
    ("SCAFFOLD", {"client_lr": [0.1, 0.05]}, {"learning_rate": 0.1}),
    ("FedDyn", {"feddyn_alpha": [0.01, 0.1]}, {"feddyn_alpha": 0.01}),
    ("FedProx", {"prox_mu": [0.1, 0.5]}, {"fedprox_mu": 0.1}),
]
STATIC = {"server_lr": "server_lr", "client_lr": "learning_rate",
          "feddyn_alpha": "feddyn_alpha", "prox_mu": "fedprox_mu"}


@pytest.mark.parametrize("alg,axes,member0_args", POP_ALGS,
                         ids=[a for a, _, _ in POP_ALGS])
def test_population_members_match_sequential_runs(alg, axes, member0_args):
    """Each member of a population reproduces its own single-config run
    (the sweep is P real experiments), and the JAX package's population
    member by member (1e-5)."""
    pop = make(federated_optimizer=alg, population_axes=axes)
    assert pop.population.size == 2
    for r in range(3):
        metrics = pop.train_one_round(r)
    losses = metrics["train_loss"].numpy()
    assert losses.shape == (2,)
    name, values = next(iter(axes.items()))
    for m, over in enumerate((member0_args, {STATIC[name]: values[1]})):
        seq = make(federated_optimizer=alg, **over)
        for r in range(3):
            seq_metrics = seq.train_one_round(r)
        assert_close(fed.population_member(pop.state.global_params, m),
                     seq.state.global_params, msg=f"{alg} member {m}")
        np.testing.assert_allclose(losses[m],
                                   float(seq_metrics["train_loss"]),
                                   atol=2e-5, rtol=1e-4)

    # against the JAX package's population (server Adam at a lr where the
    # two packages' rounding is not amplified: see the module docstring)
    if alg == "FedOpt":
        axes = {"server_lr": [0.03, 0.01]}
    japi, tapi, model = pair(federated_optimizer=alg, population_axes=axes)
    for r in range(3):
        jm, tm = japi.train_one_round(r), tapi.train_one_round(r)
        np.testing.assert_allclose(tm["train_loss"].numpy(),
                                   np.asarray(jm["train_loss"]), rtol=0,
                                   atol=TOL)
        members_close(japi, tapi, model)
    if tapi.client_table is not None:
        members_close(japi, tapi, model, "client_table")


def test_population_seed_axis_gives_distinct_members():
    """``population: P`` alone sweeps seeds: members share cohorts but
    draw member-distinct dropout masks, so one update is enough for their
    params to diverge."""
    api = make(population=3, model="cnn", comm_round=2, train_size=384,
               client_num_in_total=6, client_num_per_round=4)
    m = api.train_one_round(0)
    assert m["train_loss"].shape == (3,)
    api.train_one_round(1)
    p0 = fed.population_member(api.state.global_params, 0)
    p1 = fed.population_member(api.state.global_params, 1)
    assert max(float((p0[k] - p1[k]).abs().max()) for k in p0) > 0, \
        "seed-swept members never diverged"


def test_population_shares_masks_unless_seed_is_swept():
    """A population that does not sweep ``seed`` gives every member the
    round's own masks: member 0 (the static config) is the single run
    with dropout too."""
    kw = dict(model="cnn", comm_round=2, train_size=384,
              client_num_in_total=6, client_num_per_round=4)
    pop = make(population_axes={"client_lr": [0.1, 0.05]}, **kw)
    seq = make(**kw)
    for r in range(2):
        pop.train_one_round(r)
        seq.train_one_round(r)
    assert_close(fed.population_member(pop.state.global_params, 0),
                 seq.state.global_params, msg="cnn member 0")


def test_population_fused_matches_unfused():
    """The population block (the member-mapped round, K a block) equals
    the population's rounds one by one bitwise, and the JAX package's
    fused population (1e-5)."""
    axes = {"client_lr": [0.1, 0.05, 0.02]}
    japi, fused, model = pair(federated_optimizer="FedAvg",
                              population_axes=axes, comm_round=4,
                              round_block=2)
    unfused = make(federated_optimizer="FedAvg", population_axes=axes,
                   comm_round=4)
    unfused.state = unfused.state.replace(global_params={
        k: v.clone() for k, v in fused.state.global_params.items()})
    for r in range(4):
        unfused.train_one_round(r)
    fused.train()
    japi.train()
    for k, v in fused.state.global_params.items():
        assert torch.equal(v, unfused.state.global_params[k]), k
    members_close(japi, fused, model)
    last = fused.metrics_history[-1]
    assert last["members"] == 3
    assert last["member_train_loss_best"] <= last["member_train_loss_worst"]
    for t, j in zip(fused.metrics_history, japi.metrics_history):
        for key in ("train_loss", "member_train_loss_best",
                    "member_train_loss_worst"):
            assert abs(t[key] - j[key]) < TOL, (key, t, j)


def test_population_fused_scaffold_table_matches_unfused():
    """SCAFFOLD's member-stacked table through the population block:
    bitwise the unfused population's, every member's rows."""
    axes = {"client_lr": [0.1, 0.02]}
    unfused = make(federated_optimizer="SCAFFOLD", population_axes=axes,
                   comm_round=3)
    fused = make(federated_optimizer="SCAFFOLD", population_axes=axes,
                 comm_round=3, round_block=2)
    for r in range(3):
        unfused.train_one_round(r)
    fused.train()
    for k, v in unfused.client_table.items():
        assert torch.equal(v, fused.client_table[k]), k
    for k, v in unfused.state.c_server.items():
        assert torch.equal(v, fused.state.c_server[k]), k


def test_population_scaffold_table_stacked_per_member():
    """Per-client state tables stack on the member axis: each member's
    SCAFFOLD control variates evolve under its own hparams."""
    api = make(federated_optimizer="SCAFFOLD",
               population_axes={"client_lr": [0.1, 0.02]})
    for r in range(3):
        api.train_one_round(r)
    assert all(t.shape[:2] == (2, 12) for t in api.client_table.values())
    t0 = fed.population_member(api.client_table, 0)
    t1 = fed.population_member(api.client_table, 1)
    assert max(float((t0[k] - t1[k]).abs().max()) for k in t0) > 0, \
        "member tables identical despite different client lr"


def test_population_eval_and_records():
    japi, api, model = pair(federated_optimizer="FedAvg",
                            population_axes={"client_lr": [0.1, 0.01]},
                            comm_round=2, frequency_of_the_test=1)
    api.train()
    japi.train()
    loss, acc = api.evaluate()
    jloss, jacc = japi.evaluate()
    assert api.member_eval["acc"].shape == (2,)
    assert acc == pytest.approx(float(api.member_eval["acc"].mean()))
    assert abs(loss - jloss) < TOL and abs(acc - jacc) < TOL
    np.testing.assert_allclose(api.member_eval["loss"],
                               np.asarray(japi.member_eval["loss"]),
                               rtol=0, atol=TOL)
    rec = api.metrics_history[-1]
    assert rec["members"] == 2
    assert rec["member_train_loss_best"] <= rec["train_loss"] <= \
        rec["member_train_loss_worst"]
    assert [set(r) for r in api.metrics_history] == \
        [set(r) for r in japi.metrics_history]


def test_population_rejected_on_host_data_and_bucketing():
    with pytest.raises(ValueError, match="device-gather"):
        make(population=2, device_data=False)
    with pytest.raises(ValueError, match="unbucketed"):
        make(population=2, cohort_bucketing=True)


ENGINES = {
    "hierarchical": ("hierarchical_fl", "HierarchicalFedAvgAPI",
                     dict(federated_optimizer="HierarchicalFL",
                          group_num=2)),
    "async": ("async_fedavg", "AsyncFedAvgAPI",
              dict(federated_optimizer="async_fedavg")),
    "decentralized": ("decentralized", "DecentralizedFedAPI",
                      dict(federated_optimizer="dsgd")),
}
OPTIONS = {"population": (dict(population=2), NotImplementedError),
           "cohort_bucketing": (dict(cohort_bucketing=True), ValueError),
           "round_block": (dict(round_block=2), ValueError)}


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("engine", list(ENGINES))
def test_engines_with_their_own_loop_refuse_round_options(engine, option):
    """The hierarchical, async and decentralized engines run their own
    rounds: each refuses the round-program options by name (population
    with NotImplementedError, the others with ValueError, as the JAX
    package's engines do) instead of ignoring them."""
    import importlib
    module, cls, over = ENGINES[engine]
    api_cls = getattr(importlib.import_module(
        f"fedml_tpu_torch.simulation.sp.{module}"), cls)
    flags, exc = OPTIONS[option]
    with pytest.raises(exc, match=option.split("_")[0]):
        port(api_cls, t_arguments().update(**pop_cfg(**over, **flags)))


def test_hp_none_leaves_the_round_bitwise():
    """``HParams()`` with no field set resolves every hook to its static
    value: a round given it equals the round given ``hp=None``."""
    a, b = (make(federated_optimizer="FedDyn") for _ in range(2))
    clients, idx, mask, w, _ = a._stage_round_arrays(0)
    idx, mask, w = a._to_device(idx, mask, w)
    c = a._gather_c(clients)
    sa, _, ca = a.round_fn(a.state, idx, mask, w, t_rng.round_key(a._root, 0),
                           c)
    sb, _, cb = b.round_fn(b.state, idx, mask, w, t_rng.round_key(b._root, 0),
                           c, fed.HParams())
    for k, v in sa.global_params.items():
        assert torch.equal(v, sb.global_params[k]), k
    for k, v in ca.items():
        assert torch.equal(v, cb[k]), k
