"""Shared helpers of the tests that hold the port's multi-rank wire
drivers against the JAX package's: each side's ranks as threads over its
``local`` backend, the JAX driver's APIs recorded by rank, both sides
started from the JAX seed's weights (carried across by
``models/convert.py``), and the state-sync error each side's silos
receive."""

import threading

import jax
import numpy as np

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import data as j_data
from fedml_tpu import model as j_model
from fedml_tpu.core import wire as j_wire
from fedml_tpu.core.distributed.communication.local import (
    local_comm_manager as j_local)
from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.core import wire as t_wire
from fedml_tpu_torch.core.distributed.communication.local import (
    local_comm_manager as t_local)
from fedml_tpu_torch.models.convert import from_flax

#: the JAX package's reassociation bound (tests/test_client_store.py)
TOL = 2e-5
JOIN_S = 300.0


def j_args(cfg, **over):
    a = fedml_tpu.load_arguments()
    a.update(**dict(cfg, **over))
    return fedml_tpu.init(a, should_init_logs=False)


def t_args(cfg, **over):
    return fedml_tpu_torch.init(
        fedml_tpu_torch.load_arguments().update(**dict(cfg, **over)),
        should_init_logs=False)


def threads(run, ranks, local, run_id):
    """``run(rank)`` for every rank in threads (the server last)."""
    errors = []

    def guard(r):
        try:
            run(r)
        except BaseException as e:   # noqa: BLE001 — surfaced below
            errors.append(e)

    ths = [threading.Thread(target=guard, args=(r,), daemon=True)
           for r in ranks]
    for t in ths:
        t.start()
    try:
        for t in ths:
            t.join(timeout=JOIN_S)
    finally:
        local.reset_run(run_id)
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in ths), "federation deadlocked"


class SyncErrors:
    """Records, for every state sync a combine tier encodes, the largest
    distance of the params the silos decode from the server's f32 params,
    on the JAX side (``jax``) and the port's (``port``)."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        j_enc, t_enc = j_wire.WireLink.encode, t_wire.WireLink.encode

        def j_record(wl, sd, link=""):
            payload = j_enc(wl, sd, link)
            if link == "state_sync":
                sent = j_wire.WireCodec.decode(payload)["global_params"]
                self.jax.append(max(
                    float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                    for a, b in zip(
                        jax.tree_util.tree_leaves(
                            jax.device_get(sd["global_params"])),
                        jax.tree_util.tree_leaves(sent))))
            return payload

        def t_record(wl, sd, link=""):
            payload = t_enc(wl, sd, link)
            if link == "state_sync":
                sent = t_wire.WireCodec.decode(
                    payload, wl.codec.layout)["global_params"]
                self.port.append(max(
                    float(np.max(np.abs(sent[k] - v.cpu().numpy())))
                    for k, v in sd["global_params"].items()))
            return payload

        monkeypatch.setattr(j_wire.WireLink, "encode", j_record)
        monkeypatch.setattr(t_wire.WireLink, "encode", t_record)


def recorded(monkeypatch, module, name):
    """Replace ``module.name`` (a JAX API class the driver builds inside)
    by a subclass that keeps every instance, and its initial global
    params, by its rank."""
    apis, init = {}, {}
    base = getattr(module, name)

    class Recorded(base):
        def __init__(self, args, *a, **kw):
            super().__init__(args, *a, **kw)
            rank = int(getattr(args, "rank", 0))
            apis[rank] = self
            init[rank] = jax.device_get(self.state.global_params)

    monkeypatch.setattr(module, name, Recorded)
    return apis, init


def pair(monkeypatch, cfg, run_id, j_module, j_name, j_driver, t_cls,
         t_driver, ranks):
    """One federation on each side from the JAX seed's initial weights:
    returns each side's server history and final global params (the
    port's names and layout)."""
    j_apis, j_init = recorded(monkeypatch, j_module, j_name)
    j_out, t_out, built = {}, {}, {}

    def j_run(r):
        a = j_args(cfg, rank=r, backend="local", run_id="j" + run_id)
        ds, n = j_data.load(a)
        j_out[r] = j_driver(a, None, ds, j_model.create(a, n))

    threads(j_run, ranks, j_local, "j" + run_id)

    ds, n = t_data.load(t_args(cfg))
    for r in ranks:
        a = t_args(cfg, rank=r, backend="local", run_id="t" + run_id)
        m = t_model.create(a, n)
        api = t_cls(a, "cpu", ds, m)
        api.reset_params(from_flax(j_init[r], m, device="cpu"))
        built[r] = (a, ds, m, api)

    def t_run(r):
        a, ds, m, api = built[r]
        t_out[r] = t_driver(a, "cpu", ds, m, api=api)

    threads(t_run, ranks, t_local, "t" + run_id)
    model = built[0][2]
    return (j_out[0], t_out[0],
            from_flax(jax.device_get(j_apis[0].state.global_params), model,
                      device="cpu"),
            built[0][3].state.global_params)


def losses(hist):
    return [float(h["train_loss"]) for h in hist]


def assert_params_close(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=TOL, err_msg=k)
