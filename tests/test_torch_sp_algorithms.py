"""The port's algorithm zoo on the sp frame against the JAX package's, on
the CPU.

Each case starts both ``FedAvgAPI`` engines from the same weights (the JAX
init carried across by ``models/convert.py``) on a ragged (hetero) split,
so the cohorts, batch schedules and step masks are bitwise the same and
the rounds differ only by f32 rounding.  Tolerance: after each of three
rounds the global params, ``train_loss``, every ``ServerState`` field
(FedOpt's optimizer state, SCAFFOLD's c_server, FedDyn's h, Mime's
momentum) and every row of the per-client state table within 1e-5
(absolute); ``evaluate()`` too at the end.

FedOpt's server Adam runs at ``server_lr`` 0.03 here.  At its default
``server_lr`` 1.0 (with client lr 0.1) the same three rounds differ by
1.7e-4: Adam's normalised step turns f32 summation-order noise on
near-zero pseudo-gradient entries into steps of order ``server_lr``.  At
0.03 they differ by 5.6e-7.  Server SGD (momentum 0.9) runs at 1.0.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.core import federated as j_federated
from fedml_tpu.core import tree as j_tree
from fedml_tpu.ml.aggregator.agg_operator import \
    ServerOptimizer as JServerOptimizer
from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI

from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.core import federated as t_federated
from fedml_tpu_torch.core import tree as t_tree
from fedml_tpu_torch.ml.aggregator.agg_operator import \
    ServerOptimizer as TServerOptimizer
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvgAPI

from .torch_sp_parity import (CNN_WEB, TOL, base_args, build, port, port_tree,
                              state_close, table_close, tiny)

LR_CASES = [
    ("fedprox", {}),
    ("fedopt", dict(server_optimizer="sgd")),
    ("fedopt", dict(server_optimizer="adam", server_lr=0.03)),
    ("fedopt_seq", dict(server_lr=0.03)),
    ("scaffold", {}),
    ("feddyn", {}),
    ("fednova", {}),
    ("mime", {}),
    ("fedsgd", {}),
    ("qfedavg", {}),
]
CNN_CASES = [("scaffold", CNN_WEB), ("feddyn", CNN_WEB), ("fednova", CNN_WEB)]


@pytest.mark.parametrize("alg,over", LR_CASES + CNN_CASES)
def test_algorithm_rounds_match_jax(alg, over):
    japi, tapi, model = build(tiny(federated_optimizer=alg, **over),
                              JFedAvgAPI, TFedAvgAPI)
    tapi.state = tapi.state.replace(
        global_params=port_tree(japi.state.global_params, model))
    ragged = False
    for r in range(3):
        jm = japi.train_one_round(r)
        tm = tapi.train_one_round(r)
        assert int(tm["allocated_steps"]) == int(jm["allocated_steps"])
        assert float(tm["total_steps"]) == float(jm["total_steps"])
        ragged |= float(tm["total_steps"]) < int(tm["allocated_steps"])
        assert abs(float(tm["train_loss"]) - float(jm["train_loss"])) < TOL
        state_close(japi, tapi, model)
        table_close(japi, tapi, model)
    assert ragged
    if tapi.client_table is not None:
        # the sampled clients' rows are written, the others still zero
        written = {i for i, s in enumerate(
            t_tree.tree_map(lambda t: t.flatten(1).abs().amax(1),
                            tapi.client_table).values()) for i in
            torch.nonzero(s).flatten().tolist()}
        sampled = set().union(*(tapi._client_sampling(r).tolist()
                                for r in range(3)))
        assert written == sampled
    jl, ja = japi.evaluate()
    tl, ta = tapi.evaluate()
    assert abs(tl - jl) < TOL and abs(ta - ja) < TOL


def _random_outs(rng, c):
    """Stacked client outputs of a 2-leaf model over ``c`` clients, the
    last one a padded (zero-weight) row, as numpy."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        gparams={"a": f(3, 4), "b": f(5)},
        params={"a": f(c, 3, 4), "b": f(c, 5)},
        delta_c={"a": f(c, 3, 4), "b": f(c, 5)},
        grad_sum={"a": f(c, 3, 4), "b": f(c, 5)},
        tau=rng.integers(0, 9, c).astype(np.float32),
        loss=np.abs(f(c)) + 0.1,
        w=np.concatenate([rng.integers(1, 50, c - 1), [0]]).astype(
            np.float32))


@pytest.mark.parametrize("alg", ["fedavg", "fedavg_seq", "fedprox", "fedopt",
                                 "fedopt_seq", "feddyn", "scaffold",
                                 "fednova", "mime", "fedsgd", "qfedavg"])
def test_spec_aggregates_match_jax(alg):
    """``build_aggregates`` per registered spec on random stacked inputs
    (numpy seed), through each package's
    ``ServerOptimizer.compute_aggregates``: the same aggregates within
    1e-5; every spec of the port is one of the JAX package's."""
    d = _random_outs(np.random.default_rng(7), 6)
    kw = dict(federated_optimizer=alg, qfed_q=2.0, learning_rate=0.05)
    jopt = JServerOptimizer(j_arguments().update(**kw))
    topt = TServerOptimizer(t_arguments().update(**kw))
    jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    tt = lambda t: t_tree.tree_map(torch.as_tensor, t)
    aux = ("delta_c", "grad_sum", "tau", "loss")
    jagg = jopt.compute_aggregates(
        types.SimpleNamespace(global_params=jt(d["gparams"])),
        jt(d["params"]), jnp.asarray(d["w"]), {k: jt(d[k]) for k in aux})
    tagg = topt.compute_aggregates(
        types.SimpleNamespace(global_params=tt(d["gparams"])),
        tt(d["params"]), torch.as_tensor(d["w"]),
        {k: (tt(d[k]) if isinstance(d[k], dict) else torch.as_tensor(d[k]))
         for k in aux})
    assert set(tagg) == set(jagg)
    for key, jv in jagg.items():
        tv = tagg[key]
        if isinstance(jv, dict):
            for k in jv:
                np.testing.assert_allclose(tv[k].numpy(), np.asarray(jv[k]),
                                           rtol=1e-6, atol=TOL,
                                           err_msg=f"{key}/{k}")
        else:
            np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6,
                                       atol=TOL, err_msg=key)
    assert t_federated.get_spec(alg).client_state == \
        j_federated.get_spec(alg).client_state


def test_weighted_reduce_and_broadcast_match_jax():
    d = _random_outs(np.random.default_rng(11), 5)
    ref = j_federated.weighted_reduce(
        jax.tree_util.tree_map(jnp.asarray, d["params"]),
        jnp.asarray(d["w"]))
    got = t_federated.weighted_reduce(
        t_tree.tree_map(torch.as_tensor, d["params"]), torch.as_tensor(d["w"]))
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    tree = {"a": torch.ones(2)}
    assert t_federated.broadcast(tree) is tree


@pytest.mark.parametrize("cohort", [[3, 0, 5], [2, 8, 7, 9]])
def test_client_table_gather_and_scatter_match_jax(cohort):
    """Out-of-range ids (the padded-cohort sentinel 8 of 8 rows, and 9)
    read as zero rows and are dropped on write, never clamped onto the
    last real row, as the JAX table's ``mode="fill"``/``"drop"``.  A
    negative id is out of range too in the port (JAX wraps it as a Python
    index; no engine passes one)."""
    rng = np.random.default_rng(3)
    table = {"a": rng.standard_normal((8, 3, 2)).astype(np.float32),
             "b": rng.standard_normal((8, 4)).astype(np.float32)}
    new = {k: rng.standard_normal((len(cohort),) + v.shape[1:]).astype(
        np.float32) for k, v in table.items()}
    ids = np.asarray(cohort, np.int32)
    jg = j_tree.cohort_gather({k: jnp.asarray(v) for k, v in table.items()},
                              jnp.asarray(ids))
    js = j_tree.cohort_scatter({k: jnp.asarray(v) for k, v in table.items()},
                               jnp.asarray(ids),
                               {k: jnp.asarray(v) for k, v in new.items()})
    tg = t_tree.cohort_gather(t_tree.tree_map(torch.as_tensor, table), ids)
    ts = t_tree.cohort_scatter(t_tree.tree_map(torch.as_tensor, table), ids,
                               t_tree.tree_map(torch.as_tensor, new))
    for k in table:
        assert np.array_equal(tg[k].numpy(), np.asarray(jg[k]))
        assert np.array_equal(ts[k].numpy(), np.asarray(js[k]))
    if 8 in cohort:
        pos = cohort.index(8)
        assert not tg["a"][pos].any()
        assert np.array_equal(ts["a"][7].numpy(), new["a"][cohort.index(7)])
    neg = np.asarray([-1, 3])
    t = t_tree.tree_map(torch.as_tensor, table)
    assert not t_tree.cohort_gather(t, neg)["a"][0].any()
    after = t_tree.cohort_scatter(t, neg, t_tree.tree_map(
        lambda v: torch.as_tensor(v[:2]), new))
    assert torch.equal(after["a"][7], t["a"][7])
    assert torch.equal(after["a"][3], torch.as_tensor(new["a"][1]))


def test_client_table_init_matches_jax():
    params = {"w": torch.ones(3, 2), "b": torch.ones(2)}
    table = t_tree.client_table_init(params, 5)
    ref = j_tree.client_table_init({k: jnp.asarray(v.numpy())
                                    for k, v in params.items()}, 5)
    for k, v in table.items():
        assert v.shape == ref[k].shape and v.dtype == torch.float32
        assert not v.any()


def test_server_adam_keeps_the_client_defaults():
    """The client's Adam keeps optax's b1 0.9, b2 0.999, eps 1e-8; FedOpt's
    server Adam is ``optax.adam(server_lr, b1=server_momentum, b2=0.99)``:
    the port's step equals optax's over three steps on the same
    gradients."""
    import optax

    from fedml_tpu_torch.core.state import make_client_optimizer
    client = make_client_optimizer(t_arguments().update(
        client_optimizer="adam", learning_rate=0.01))
    assert (client.b1, client.b2, client.eps) == (0.9, 0.999, 1e-8)
    server = TServerOptimizer(t_arguments().update(
        federated_optimizer="fedopt", server_lr=0.5, server_momentum=0.8))
    tx = optax.adam(0.5, b1=0.8, b2=0.99)
    rng = np.random.default_rng(1)
    p = rng.standard_normal(6).astype(np.float32)
    jstate, tstate = tx.init(jnp.asarray(p)), server.server_tx.init(
        {"p": torch.as_tensor(p)})
    for _ in range(3):
        g = rng.standard_normal(6).astype(np.float32)
        ju, jstate = tx.update(jnp.asarray(g), jstate, jnp.asarray(p))
        tu, tstate = server.server_tx.update({"p": torch.as_tensor(g)},
                                             tstate, {"p": torch.as_tensor(p)})
        np.testing.assert_allclose(tu["p"].numpy(), np.asarray(ju),
                                   rtol=1e-6, atol=1e-7)


# -- the learning tests of tests/test_algorithms.py, mirrored --------------

@pytest.mark.parametrize("opt", ["FedAvg", "FedProx", "FedOpt", "SCAFFOLD",
                                 "FedNova", "FedDyn", "Mime", "FedSGD",
                                 "qFedAvg"])
def test_optimizer_learns(opt):
    """Mirrors ``test_algorithms.py::test_optimizer_learns``: each
    optimizer beats ``max(acc0, 0.3)``; the stateful ones write their
    state."""
    over = dict(federated_optimizer=opt)
    if opt == "FedSGD":
        over.update(server_lr=0.5, comm_round=12)
    api = port(TFedAvgAPI, base_args(**over))
    _, acc0 = api.evaluate()
    api.train()
    _, acc1 = api.evaluate()
    assert acc1 > max(acc0, 0.3), (opt, acc0, acc1)
    nonzero = lambda d: max(float(v.abs().max()) for v in d.values()) > 0
    if opt in ("SCAFFOLD", "FedDyn"):
        assert api.client_table is not None and nonzero(api.client_table)
    if opt == "SCAFFOLD":
        assert nonzero(api.state.c_server)
    if opt == "FedDyn":
        assert nonzero(api.state.h)
    if opt == "FedOpt":
        assert nonzero(api.state.opt_state)
    if opt == "Mime":
        assert nonzero(api.state.momentum)

