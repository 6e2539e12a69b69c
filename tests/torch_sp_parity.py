"""Shared helpers of the port's sp parity tests (``test_torch_sp_*.py``):
build a JAX engine and its port counterpart on the same data, start both
from the JAX engine's weights (carried across by ``models/convert.py``),
and compare params, server state and per-client state tables."""

import jax
import numpy as np

from fedml_tpu import data as j_data
from fedml_tpu import model as j_model
from fedml_tpu.arguments import load_arguments as j_arguments

from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.models.convert import from_flax

TOL = 1e-5


def tiny(**over):
    """A small synthetic config with ragged (hetero) clients: 8 clients, 4
    a round, 16 a batch."""
    cfg = dict(dataset="synthetic", num_classes=10, input_shape=(28, 28, 1),
               model="lr", client_num_in_total=8, client_num_per_round=4,
               comm_round=3, epochs=1, batch_size=16, learning_rate=0.1,
               train_size=512, test_size=256, frequency_of_the_test=2,
               random_seed=42, data_cache_dir="", partition_method="hetero",
               partition_alpha=0.3)
    cfg.update(over)
    return cfg


#: the ``cnn_web`` variant of :func:`tiny`
CNN_WEB = dict(model="cnn_web", input_shape=(12, 12, 1), train_size=256,
               test_size=64, batch_size=8, learning_rate=0.05)


def base_args(**over):
    """``tests/test_algorithms.py``'s ``base_args``, as the port's
    arguments."""
    cfg = dict(dataset="synthetic", num_classes=10, input_shape=(14, 14, 1),
               train_size=1024, test_size=256, model="lr",
               client_num_in_total=12, client_num_per_round=6, comm_round=6,
               epochs=1, batch_size=16, learning_rate=0.1, random_seed=5,
               frequency_of_the_test=100, data_cache_dir="")
    cfg.update(over)
    return t_arguments().update(**cfg)


def port(api_cls, args, **kw):
    """The port's engine ``api_cls`` for ``args`` on the CPU."""
    ds, out = t_data.load(args)
    return api_cls(args, "cpu", ds, t_model.create(args, out), **kw)


def build(cfg, j_cls, t_cls, **kw):
    """The JAX engine ``j_cls`` and the port's ``t_cls`` (on the CPU) for
    ``cfg``; returns (jax_api, port_api, port_model)."""
    jargs = j_arguments().update(**cfg)
    jds, jout = j_data.load(jargs)
    japi = j_cls(jargs, None, jds, j_model.create(jargs, jout), **kw)
    targs = t_arguments().update(**cfg)
    tds, tout = t_data.load(targs)
    tmodel = t_model.create(targs, tout)
    tapi = t_cls(targs, "cpu", tds, tmodel, **kw)
    return japi, tapi, tmodel


def port_tree(jtree, model):
    """A JAX params-shaped tree as the port's ``{name: tensor}`` dict."""
    return from_flax(jax.device_get(jtree), model, device="cpu")


def tree_close(got, jtree, model, what, tol=TOL):
    ref = port_tree(jtree, model)
    assert set(got) == set(ref), what
    for k, v in got.items():
        np.testing.assert_allclose(v.detach().numpy(), ref[k].numpy(),
                                   rtol=0, atol=tol, err_msg=f"{what} {k}")


def opt_state_close(got, jstate, model, what, tol=TOL):
    """The port's server-optimizer state dict against optax's chain state
    (``(TraceState | ScaleByAdamState, EmptyState)``)."""
    inner = jstate[0]
    if hasattr(inner, "trace"):
        trees = {"trace": inner.trace}
    else:
        trees = {"mu": inner.mu, "nu": inner.nu}
        assert int(got["count"]) == int(inner.count), what
    assert set(got) - {"count"} == {f"{p}/{k}" for p in trees
                                    for k in port_tree(trees[p], model)}
    for p, t in trees.items():
        tree_close({k[len(p) + 1:]: v for k, v in got.items()
                    if k.startswith(p + "/")}, t, model, f"{what} {p}", tol)


def state_close(japi, tapi, model, tol=TOL):
    """Every ServerState field of the port against the JAX engine's."""
    js, ts = japi.state, tapi.state
    assert ts.round_idx == int(js.round_idx)
    tree_close(ts.global_params, js.global_params, model, "params", tol)
    for f in ("c_server", "h", "momentum"):
        jv, tv = getattr(js, f), getattr(ts, f)
        assert (jv is None) == (tv is None), f
        if tv is not None:
            tree_close(tv, jv, model, f, tol)
    if ts.opt_state is not None:
        opt_state_close(ts.opt_state, js.opt_state, model, "opt_state", tol)


def table_close(japi, tapi, model, tol=TOL):
    """Every row of the per-client state table."""
    jt, tt = japi.client_table, tapi.client_table
    assert (jt is None) == (tt is None)
    if tt is None:
        return
    rows = next(iter(tt.values())).shape[0]
    assert rows == tapi.dataset.num_clients
    for i in range(rows):
        tree_close({k: v[i] for k, v in tt.items()},
                   jax.tree_util.tree_map(lambda l: l[i], jt), model,
                   f"table row {i}", tol)
