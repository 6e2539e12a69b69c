"""The port's secure aggregation against the JAX package's, on the CPU.

``core/mpc`` is host numpy in both packages: every function is held
bitwise on the same inputs, LightSecAgg's one-process round with a
dropout included; the port's decode (the inverted U×U matrix applied in
int64) is pinned against the JAX elimination on object arrays.  The SecAgg
and LightSecAgg FSMs run a server and 3 clients on threads over ``local``:
with the JAX package's ``ToyTrainer`` each round's global params are the
JAX run's bitwise, also where |Σ nᵢ·xᵢ| passes the field's range and the
sum wraps; with each package's cross-silo ``lr`` silo trainer, from the
JAX server's initial weights, within ``TOL``."""

import threading
import types

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.core.mpc import lightsecagg as JL
from fedml_tpu.core.mpc import secagg as JS
from fedml_tpu_torch.core.mpc import lightsecagg as TL
from fedml_tpu_torch.core.mpc import secagg as TS
from fedml_tpu_torch.models.convert import from_flax

from .torch_cross_silo_parity import LR, args_for

TOL = 1e-6
JOIN_S = 60.0


def _vec(seed, d=37, scale=1.0):
    return (np.random.default_rng(seed).normal(size=d) * scale).astype(
        np.float32)


def _field(seed, shape):
    return np.random.default_rng(seed).integers(0, TS.P, shape,
                                                dtype=np.int64)


PAIR_SEEDS = {(i, j): 1000 + 10 * i + j for i in range(4)
              for j in range(i + 1, 4)}

#: name → (function name, module, args): each called in both packages
CASES = {
    "modular_inv": ("modular_inv", "s", (123456789,)),
    "quantize": ("quantize", "s", (_vec(0, scale=100.0),)),
    "dequantize": ("dequantize", "s", (_field(1, 37),)),
    "eval_poly_matrix": ("_eval_poly_matrix", "s", (_field(2, (3, 9)),
                                                    [1, 2, 3, 4])),
    "shamir_share": ("shamir_share", "s", (_field(3, 5), 5, 3, 7)),
    "prg_mask": ("prg_mask", "s", (99, 41)),
    "pairwise_mask": ("pairwise_mask", "s", (2, range(4), PAIR_SEEDS, 17)),
    "masked_input": ("masked_input", "s", (_vec(4), 1, range(4),
                                           PAIR_SEEDS, 77)),
    "secure_sum": ("secure_sum", "s", ([_field(5 + i, 23) for i in range(3)],
                                       [11, 12, 13])),
    "vandermonde": ("_vandermonde", "l", ([1, 2, 4, 5], 4)),
    "solve_field": ("_solve_field", "l", (JL._vandermonde([2, 3, 5], 3),
                                          _field(6, (3, 8)))),
    "mask_encoding": ("mask_encoding", "l", (20, 5, 4, 1, _field(7, 21), 3)),
    "aggregate_shares": ("aggregate_shares", "l", ([_field(8 + i, 13)
                                                    for i in range(4)],)),
    "decode_aggregate_mask": ("decode_aggregate_mask", "l", (
        {i: _field(20 + i, 11) for i in (1, 2, 4, 5)}, 30, 4)),
    "lightsecagg_round": ("lightsecagg_round", "l", (
        [_vec(30 + i, 11) for i in range(5)], 5, 4, 1, [0, 1, 3, 4])),
}


def _bitwise(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _bitwise(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mpc_functions_are_bitwise_the_jax_ones(case):
    name, mod, args = CASES[case]
    j = getattr(JS if mod == "s" else JL, name)
    t = getattr(TS if mod == "s" else TL, name)
    _bitwise(t(*args), j(*args))


def test_shamir_reconstruct_and_the_wide_decode_are_bitwise():
    secret = JS.quantize(np.array([0.5, -1.25, 3.0]))
    shares = TS.shamir_share(secret, n=5, t=3, seed=7)
    for pick in ([1, 3, 5], [2, 4, 5]):
        sub = {k: shares[k] for k in pick}
        _bitwise(TS.shamir_reconstruct(sub), JS.shamir_reconstruct(sub))
        _bitwise(TS.shamir_reconstruct(sub), secret)
    # the port's decode against the elimination on the whole object array
    for ids, u in (([1, 2], 2), ([2, 3, 5], 3), ([1, 3, 4, 6], 4)):
        V = TL._vandermonde(ids, u)
        B = _field(40 + u, (u, 1000))
        _bitwise(TL._apply_inverse(V, B), JL._solve_field(V, B))


def test_the_field_wraps_alike_in_both_packages():
    """|Σ nᵢ·xᵢ| past (p − 1)/2 / 2¹⁶ ≈ 16,384 wraps: both packages give
    the same wrapped sum, far from the plaintext."""
    xs = [np.full(6, 100.0 + i, np.float32) for i in range(3)]
    ns = [60.0, 70.0, 80.0]
    self_seeds = [5, 6, 7]
    out = {}
    for name, mod in (("jax", JS), ("port", TS)):
        masked = [mod.masked_input(x * n, i, range(3), PAIR_SEEDS, s)
                  for i, (x, n, s) in enumerate(zip(xs, ns, self_seeds))]
        out[name] = mod.dequantize(mod.secure_sum(masked, self_seeds))
    _bitwise(out["port"], out["jax"])
    plain = sum(n * x for n, x in zip(ns, xs))
    assert plain.max() > (TS.P - 1) / 2 / (1 << 16)
    assert np.abs(out["port"] - plain).min() > 1e3


class ToyTrainer:
    """The JAX package's test trainer: params + rank, rank*10 samples."""

    def __init__(self, rank):
        self.rank = rank

    def train(self, global_params, round_idx):
        new = {k: np.asarray(v) + self.rank for k, v in global_params.items()}
        return new, 10 * self.rank


class SiloTrainer:
    """A cross-silo silo trainer (either package's ``TrainerDistAdapter``)
    on the silo's own data: ``train(global_params, round_idx)``."""

    def __init__(self, adapter, data_idx):
        self.adapter, self.data_idx = adapter, data_idx

    def train(self, global_params, round_idx):
        return self.adapter.train(global_params, self.data_idx, round_idx)


def _run(pkg, kind, run_id, init, trainers, **over):
    """Server + 3 clients on threads: each round's global params."""
    if pkg == "jax":
        from fedml_tpu.core.distributed.communication.local.\
            local_comm_manager import reset_run
        if kind == "sa":
            from fedml_tpu.cross_silo.secagg import (SAClientManager as C,
                                                     SAServerManager as S)
        else:
            from fedml_tpu.cross_silo.lightsecagg import (
                LSAClientManager as C, LSAServerManager as S)
    else:
        from fedml_tpu_torch.core.distributed.communication.local.\
            local_comm_manager import reset_run
        if kind == "sa":
            from fedml_tpu_torch.cross_silo.secagg import (
                SAClientManager as C, SAServerManager as S)
        else:
            from fedml_tpu_torch.cross_silo.lightsecagg import (
                LSAClientManager as C, LSAServerManager as S)
    reset_run(run_id)
    rounds = []

    def args(rank):
        return types.SimpleNamespace(
            rank=rank, run_id=run_id, worker_num=4, comm_round=2,
            random_seed=0, privacy_guarantee=1,
            targeted_number_active_clients=3, **over)

    kw = {} if pkg == "jax" else {"device": "cpu"}
    server = S(args(0), init, rank=0, size=4,
               on_round_done=lambda r, p: rounds.append(
                   jax.tree_util.tree_map(np.array, p)), **kw)
    clients = [C(args(r), trainers[r - 1], rank=r, size=4) for r in (1, 2, 3)]
    threads = [threading.Thread(target=m.run, daemon=True)
               for m in [server] + clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert all(not t.is_alive() for t in threads), f"{kind} FSM stalled"
    assert len(rounds) == 2
    return rounds, server


@pytest.mark.parametrize("start", [0.0, 1000.0])
@pytest.mark.parametrize("kind", ["sa", "lsa"])
def test_fsms_with_the_toy_trainer_are_bitwise_the_jax_ones(kind, start):
    """``start`` 1000: Σ nᵢ·xᵢ ≈ 60,000 wraps the field in both."""
    init = {"w": np.full(5, start, np.float32),
            "b": np.full(2, start, np.float32)}
    trainers = [ToyTrainer(r) for r in (1, 2, 3)]
    j_rounds, _ = _run("jax", kind, f"{kind}_j_{start}", init, trainers)
    t_rounds, server = _run("port", kind, f"{kind}_t_{start}", init,
                            trainers)
    for j, t in zip(j_rounds, t_rounds):
        _bitwise(t, j)
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in server.global_params.values())
    g = np.full(5, start)
    for _ in range(2):
        g = sum(10.0 * r * (g + r) for r in (1, 2, 3)) / 60.0
    if start == 0.0:
        np.testing.assert_allclose(t_rounds[-1]["w"], g, atol=1e-3)
    else:
        assert np.abs(t_rounds[-1]["w"] - g).min() > 1.0


@pytest.mark.parametrize("kind", ["sa", "lsa"])
def test_fsms_with_lr_silo_trainers_match_jax(kind):
    from fedml_tpu import data as j_data
    from fedml_tpu import model as j_model
    from fedml_tpu.cross_silo.client.fedml_client_master_manager import \
        TrainerDistAdapter as JAdapter
    from fedml_tpu_torch import data as t_data
    from fedml_tpu_torch import model as t_model
    from fedml_tpu_torch.cross_silo.client.fedml_client_master_manager \
        import TrainerDistAdapter as TAdapter

    cfg = dict(LR, client_num_in_total=3, client_num_per_round=3,
               client_id_list=[1, 2, 3], train_size=240)
    ja = args_for("jax", cfg, "local", 0, f"{kind}_lr")
    ds, n_out = j_data.load(ja)
    jm = j_model.create(ja, n_out)
    from fedml_tpu.core import rng as j_rng
    init = jax.device_get(jm.init(j_rng.purpose_key(j_rng.root_key(
        int(ja.random_seed)), "init")))
    j_adapter = JAdapter(ja, jm, ds)   # jitted once, shared by the threads
    j_trainers = [SiloTrainer(j_adapter, r) for r in range(3)]
    j_rounds, _ = _run("jax", kind, f"{kind}_lr_j", init, j_trainers)

    ta = args_for("port", cfg, "local", 0, f"{kind}_lr")
    tds, t_out = t_data.load(ta)
    tm = t_model.create(ta, t_out)
    t_init = from_flax(init, tm, device="cpu")
    # one model a thread: the functional transforms are not thread-safe
    t_trainers = [SiloTrainer(TAdapter(ta, t_model.create(ta, t_out), tds,
                                       device="cpu"), r) for r in range(3)]
    t_rounds, _ = _run("port", kind, f"{kind}_lr_t", t_init, t_trainers)
    for r, (j, t) in enumerate(zip(j_rounds, t_rounds)):
        ref = from_flax(j, tm, device="cpu")
        assert sorted(t) == sorted(ref)
        for k in t:
            np.testing.assert_allclose(t[k], ref[k].numpy(), rtol=0,
                                       atol=TOL, err_msg=f"round {r} {k}")
