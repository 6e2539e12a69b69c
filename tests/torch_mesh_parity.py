"""Shared helpers of the port's mesh parity tests (``test_torch_mesh*.py``):
the JAX package's mesh engine as the oracle, the port's mesh on spawned
gloo ranks (``tests/torch_mesh_ranks.py``), and their comparison.

The JAX mesh engine (``fedml_tpu/simulation/mesh/engine.py``) passes
``auto=layout.auto_axes`` to ``jax.shard_map``.  On the 1-D layout that
set is empty, and a ``jax.shard_map`` without the ``auto`` keyword (the
jax of some images) refuses it by name.  :func:`jax_shard_map_1d` drops
the keyword while it is empty, which is the same program: a fully manual
``shard_map``.  It changes nothing where ``jax.shard_map`` takes
``auto``, and it is undone on exit."""

import contextlib
import inspect

import jax
import numpy as np

from fedml_tpu import data as j_data
from fedml_tpu import model as j_model
from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.core.mesh import make_mesh as j_make_mesh

from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.models.convert import from_flax

#: the JAX tests' own limits for mesh parity (tests/test_update_sharding.py)
ATOL, RTOL = 2e-5, 1e-4

#: tests/test_update_sharding.py:50
STATEFUL_ALGS = ["FedAvg", "FedOpt", "SCAFFOLD", "FedDyn", "FedNova", "Mime"]

#: each spawn of ranks must end within this many seconds
SPAWN_TIMEOUT = 240


def mesh_cfg(**over):
    """``tests/test_update_sharding.py``'s ``args_for``: 16 clients, 8 a
    round, ``lr`` on synthetic 28x28 images, seed 7.  FedOpt's server Adam
    runs at ``server_lr`` 0.03, as in the port's sp parity tests: at 1.0
    its normalised step turns f32 summation-order noise between the two
    packages into steps of order ``server_lr``."""
    cfg = dict(dataset="synthetic", num_classes=10, input_shape=(28, 28, 1),
               train_size=1024, test_size=256, model="lr",
               client_num_in_total=16, client_num_per_round=8, comm_round=3,
               epochs=1, batch_size=16, learning_rate=0.1, random_seed=7,
               frequency_of_the_test=10 ** 9, data_cache_dir="")
    cfg.update(over)
    if str(cfg.get("federated_optimizer", "")).lower() == "fedopt":
        cfg.setdefault("server_lr", 0.03)
    return cfg


@contextlib.contextmanager
def jax_shard_map_1d():
    """See the module docstring."""
    orig = jax.shard_map
    params = inspect.signature(orig).parameters
    if "auto" in params or any(p.kind is p.VAR_KEYWORD
                               for p in params.values()):
        yield
        return

    def shard_map(f, *args, auto=frozenset(), **kw):
        if auto:
            raise NotImplementedError("auto axes need the 2-D layout")
        return orig(f, *args, **kw)

    jax.shard_map = shard_map
    try:
        yield
    finally:
        jax.shard_map = orig


def port_model(cfg):
    args = t_arguments().update(**cfg)
    _, out = t_data.load(args)
    return t_model.create(args, out)


def to_port(jtree, model):
    """A JAX params-shaped tree as the port's dict of numpy arrays."""
    return {k: v.numpy() for k, v in
            from_flax(jax.device_get(jtree), model, device="cpu").items()}


def jax_api(cls, cfg, **kw):
    jargs = j_arguments().update(**cfg)
    ds, out = j_data.load(jargs)
    return cls(jargs, None, ds, j_model.create(jargs, out), **kw)


def jax_mesh(cfg, n_shards, rounds):
    """The JAX mesh engine on ``n_shards`` of the virtual CPU devices,
    ``rounds`` rounds through ``train_one_round``.  Returns ``(api, init,
    losses)`` with ``init`` its starting params (JAX tree)."""
    from fedml_tpu.simulation.mesh.mesh_simulator import MeshFedAvgAPI
    with jax_shard_map_1d():
        api = jax_api(MeshFedAvgAPI, cfg, mesh=j_make_mesh(
            client=n_shards, devices=jax.devices()[:n_shards]))
        init = jax.device_get(api.state.global_params)
        ms = [api.train_one_round(r) for r in range(rounds)]
    return api, init, [(float(m["train_loss"]), float(m["total_steps"]))
                       for m in ms]


def close(got, want, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol, err_msg=what)


def tree_close(got, jtree, model, what, atol=ATOL, rtol=RTOL):
    ref = to_port(jtree, model)
    assert set(got) == set(ref), what
    for k in ref:
        close(got[k], ref[k], f"{what} {k}", atol, rtol)


def opt_state_close(got, jstate, model, flat, what):
    """The port's server-optimizer state against optax's ``(ScaleByAdam |
    Trace, EmptyState)``: trees in the replicated layout, flat vectors in
    the scatter one."""
    inner = jstate[0]
    trees = ({"trace": inner.trace} if hasattr(inner, "trace")
             else {"mu": inner.mu, "nu": inner.nu})
    if "count" in got:
        assert int(got["count"]) == int(inner.count), what
    for p, t in trees.items():
        if flat:
            close(got[f"{p}/flat"], np.asarray(t), f"{what} {p}")
        else:
            tree_close({k[len(p) + 1:]: v for k, v in got.items()
                        if k.startswith(p + "/")}, t, model, f"{what} {p}")


def state_close(res, japi, model, what):
    """A port rank's whole state (``mesh_cases`` result) against the JAX
    mesh engine's: params, every aux field in its layout, the client
    table, and the round counter."""
    st, js = res["state"], japi.state
    scatter = res["layout"] == "scatter"
    assert st["round_idx"] == int(js.round_idx), what
    tree_close(st["global_params"], js.global_params, model,
               f"{what} params")
    for f in ("c_server", "h", "momentum"):
        jv, tv = getattr(js, f), st[f]
        assert (jv is None) == (tv is None), (what, f)
        if tv is None:
            continue
        if scatter:
            close(tv, np.asarray(jv), f"{what} {f}")
        else:
            tree_close(tv, jv, model, f"{what} {f}")
    if st["opt_state"] is not None:
        opt_state_close(st["opt_state"], js.opt_state, model, scatter,
                        f"{what} opt_state")
    table = res["table"]
    assert (table is None) == (japi.client_table is None), what
    if table is not None:
        rows = next(iter(table.values())).shape[0]
        for i in range(rows):
            tree_close({k: v[i] for k, v in table.items()},
                       jax.tree_util.tree_map(lambda l: np.asarray(l)[i],
                                              japi.client_table), model,
                       f"{what} table row {i}")
