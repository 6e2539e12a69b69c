"""The port's attacks, differential privacy and alg-frame trust hooks
against the JAX package's, on the CPU.

Each attack and mode, each DP mechanism and frame runs the same numpy
inputs through both packages; the noising ones draw the JAX package's own
draws (``tests/torch_trust_parity.py``), so the rest of their arithmetic
is held to the JAX one within ``TOL``.  The numpy modules (the data
poisoning attacks and the RDP accountant) are copies, held bitwise.  The
attacker's reset on ``init`` is a deliberate divergence, pinned here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu_torch.arguments import load_arguments as t_arguments

from .torch_trust_parity import (record_jax_draws, replay_draws,
                                 reset_singletons)

TOL = 1e-6

#: DLG / inverting gradients: Adam steps on the dummy data, each through a
#: second-order gradient; f32 rounding grows over the steps
RECON_TOL = 1e-5


def _tree(rng, bad=0.0):
    return {"b": (rng.normal(size=4) + bad).astype(np.float32),
            "w": (rng.normal(size=(4, 3)) + bad).astype(np.float32)}


def _lists(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [(10.0 + i, _tree(rng)) for i in range(n)]


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _close(got, want, tol=TOL):
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=tol, atol=tol,
                                   err_msg=k)


def _both(monkeypatch, jax_fn, port_fn):
    """Run the JAX side with its draws logged, then the port's on the
    same draws; every JAX draw must be used."""
    draws = record_jax_draws(monkeypatch)
    want = jax_fn()
    replay_draws(monkeypatch, draws)
    got = port_fn()
    assert not any(draws.values()), "JAX drew noise the port did not"
    return got, want


@pytest.mark.parametrize("mode", ["zero", "flip", "random"])
def test_byzantine_attack_matches_jax(mode, monkeypatch):
    from fedml_tpu.core.security.attack.byzantine_attack import \
        ByzantineAttack as J
    from fedml_tpu_torch.core.security.attack.byzantine_attack import \
        ByzantineAttack as T

    kw = dict(byzantine_client_num=2, attack_mode=mode, random_seed=5)
    raw = _lists()
    got, want = _both(
        monkeypatch,
        lambda: J(j_arguments().update(**kw)).attack_model_list(
            [(n, _j(p)) for n, p in raw]),
        lambda: T(t_arguments().update(**kw)).attack_model_list(
            [(n, _t(p)) for n, p in raw]))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        _close(g, w)
    if mode != "zero":
        assert float(torch.max(torch.abs(got[0][1]["w"] - _t(raw[0][1])[
            "w"]))) > 0.1


@pytest.mark.parametrize("with_global", [False, True])
def test_model_replacement_attack_matches_jax(with_global):
    from fedml_tpu.core.security.attack.model_replacement_attack import \
        ModelReplacementBackdoorAttack as J
    from fedml_tpu_torch.core.security.attack.model_replacement_attack \
        import ModelReplacementBackdoorAttack as T

    raw = _lists()
    glob = _tree(np.random.default_rng(9))
    out = {}
    for pkg, cls, args, conv in (("jax", J, j_arguments, _j),
                                 ("port", T, t_arguments, _t)):
        a = cls(args().update(client_num_per_round=4))
        if with_global:
            a.set_global_model(conv(glob))
        out[pkg] = a.attack_model_list([(n, conv(p)) for n, p in raw])
    for (_, g), (_, w) in zip(out["port"], out["jax"]):
        _close(g, w)


@pytest.mark.parametrize("with_global", [False, True])
def test_lazy_worker_attack_matches_jax(with_global, monkeypatch):
    from fedml_tpu.core.security.attack.lazy_worker_attack import \
        LazyWorkerAttack as J
    from fedml_tpu_torch.core.security.attack.lazy_worker_attack import \
        LazyWorkerAttack as T

    raw = _lists()
    glob = _tree(np.random.default_rng(9))

    def run(cls, args, conv):
        a = cls(args().update(random_seed=2, lazy_noise_scale=0.01))
        if with_global:
            a.set_global_model(conv(glob))
        return a.attack_model_list([(n, conv(p)) for n, p in raw])

    got, want = _both(monkeypatch, lambda: run(J, j_arguments, _j),
                      lambda: run(T, t_arguments, _t))
    for (_, g), (_, w) in zip(got, want):
        _close(g, w)


def test_data_poisoning_attacks_are_bitwise_the_jax_ones():
    """Label flipping, the pixel backdoor and the edge-case backdoor
    (synthesized and from a pool) are numpy copies: bitwise equal."""
    from fedml_tpu.core.security.attack import backdoor_attack as jb
    from fedml_tpu.core.security.attack import label_flipping_attack as jl
    from fedml_tpu_torch.core.security.attack import backdoor_attack as tb
    from fedml_tpu_torch.core.security.attack import \
        label_flipping_attack as tl

    rng = np.random.default_rng(0)
    x = rng.random((10, 4, 4, 1)).astype(np.float32)
    y = np.array([0, 1, 2, 3, 1, 2, 0, 1, 2, 3])
    kw = dict(original_class_list=[1, 2], target_class_list=[7, 8],
              backdoor_target_label=5, backdoor_trigger_frac=0.5)
    pool = (rng.random((3, 4, 4, 1)).astype(np.float32), np.array([9, 8, 7]))
    outs = {}
    for pkg, lab, bd, args in (("jax", jl, jb, j_arguments),
                               ("port", tl, tb, t_arguments)):
        a = args().update(**kw)
        edge = bd.EdgeCaseBackdoorAttack(a)
        pooled = bd.EdgeCaseBackdoorAttack(a)
        pooled.set_edge_pool(*pool)
        outs[pkg] = [lab.LabelFlippingAttack(a).poison_data((x, y)),
                     bd.BackdoorAttack(a).poison_data((x, y)),
                     edge.poison_data((x, y)), pooled.poison_data((x, y))]
    for (gx, gy), (wx, wy) in zip(outs["port"], outs["jax"]):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
    assert (outs["port"][0][1][y == 1] == 7).all()


def _dlg_case():
    """A tiny dense classifier (8 inputs, 5 classes) in both packages from
    the same weights, and the victim's gradient on one batch."""
    from fedml_tpu import model as j_model
    from fedml_tpu_torch import model as t_model
    from fedml_tpu_torch.models.convert import from_flax

    cfg = dict(dataset="synthetic", num_classes=5, input_shape=(8,),
               model="lr")
    jm = j_model.create(j_arguments().update(**cfg), 5)
    jp = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(3)))
    tm = t_model.create(t_arguments().update(**cfg), 5)
    tp = from_flax(jp, tm, device="cpu")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[[1, 3]]

    def j_grad_fn(params, xb, yb):
        def loss(p):
            return -jnp.mean(jnp.sum(
                yb * jax.nn.log_softmax(jm.apply(p, xb)), axis=-1))
        return jax.grad(loss)(params)

    from fedml_tpu_torch.core.security.attack.gradient_inversion import \
        classifier_grad_fn
    t_grad_fn = classifier_grad_fn(tm)
    j_victim = j_grad_fn(jp, jnp.asarray(x), jnp.asarray(y))
    t_victim = {k: g.detach() for k, g in t_grad_fn(
        tp, torch.tensor(x), torch.tensor(y)).items()}
    return (jm, jp, j_grad_fn, j_victim), (tm, tp, t_grad_fn, t_victim)


@pytest.mark.parametrize("attack", ["dlg", "invert_gradient"])
def test_gradient_inversion_matches_jax(attack, monkeypatch):
    from fedml_tpu.core.security.attack import create_attacker as j_create
    from fedml_tpu_torch.core.security.attack import \
        create_attacker as t_create
    from fedml_tpu_torch.models.convert import from_flax

    (jm, jp, jg, jv), (tm, tp, tg, tv) = _dlg_case()
    kw = dict(attack_iters=6, attack_lr=0.05, random_seed=1)
    got, want = _both(
        monkeypatch,
        lambda: j_create(attack, j_arguments().update(**kw))
        .reconstruct_data(jv, (jg, jp, (2, 8), (2, 5))),
        lambda: t_create(attack, t_arguments().update(**kw))
        .reconstruct_data(tv, (tg, tp, (2, 8), (2, 5))))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RECON_TOL, atol=RECON_TOL)
    assert from_flax(jp, tm, device="cpu").keys() == tp.keys()


def test_revealing_labels_matches_jax():
    """The JAX test's scenario: zero inputs make the bias-gradient sign
    rule exact, so the classes {0, 1, 3} of the batch are found."""
    from fedml_tpu.core.security.attack.gradient_inversion import \
        RevealingLabelsAttack as J
    from fedml_tpu_torch.core.security.attack.gradient_inversion import \
        RevealingLabelsAttack as T

    (jm, jp, jg, _), (tm, tp, tg, _) = _dlg_case()
    y = np.eye(5, dtype=np.float32)[[1, 3, 3, 0]]
    x = np.zeros((4, 8), np.float32)
    jfound = J(j_arguments()).reconstruct_data(
        jg(jp, jnp.asarray(x), jnp.asarray(y)))
    from fedml_tpu_torch.core.security.defense.common import use_layout
    use_layout(tm)
    tfound = T(t_arguments()).reconstruct_data(
        {k: g.detach() for k, g in tg(tp, torch.tensor(x),
                                      torch.tensor(y)).items()})
    assert sorted(tfound.tolist()) == sorted(np.asarray(jfound).tolist()) \
        == [0, 1, 3]


def test_dp_sigma_and_the_accountant_match_jax():
    """The Gaussian σ (computed in f32 in both) and the Laplace scale
    match; the RDP accountant is a numpy copy: bitwise equal."""
    from fedml_tpu.core.dp import budget_accountant as jba
    from fedml_tpu.core.dp import mechanisms as jm
    from fedml_tpu_torch.core.dp import budget_accountant as tba
    from fedml_tpu_torch.core.dp import mechanisms as tm

    for eps, delta, sens in ((1.0, 1e-5, 1.0), (5.0, 1e-6, 0.3),
                             (0.5, 1e-3, 2.0)):
        g = (jm.Gaussian(eps, delta, sens), tm.Gaussian(eps, delta, sens))
        assert g[1].sigma == pytest.approx(g[0].sigma, rel=1e-7, abs=0)
        lap = (jm.Laplace(eps, sensitivity=sens),
               tm.Laplace(eps, sensitivity=sens))
        assert lap[1].scale == lap[0].scale
    accs = [m.BudgetAccountant() for m in (jba, tba)]
    for q, sigma, steps in ((0.01, 1.1, 1000), (0.05, 0.8, 10),
                            (1.0, 2.0, 3)):
        spent = []
        for acc in accs:
            acc.compose_subsampled_gaussian(q=q, sigma=sigma, steps=steps)
            spent.append(acc.get_privacy_spent(delta=1e-5))
        assert spent[0] == spent[1]
        assert np.array_equal(accs[0].rdp, accs[1].rdp)
    orders = jba.DEFAULT_ORDERS
    assert orders == tba.DEFAULT_ORDERS
    r = [m.compute_rdp(0.02, 1.3, 500, orders) for m in (jba, tba)]
    assert np.array_equal(r[0], r[1])
    assert jba.get_privacy_spent(orders, r[0]) == \
        tba.get_privacy_spent(orders, r[1])


@pytest.mark.parametrize("solution,mech", [
    ("local_dp", "gaussian"), ("global_dp", "gaussian"),
    ("nbafl", "gaussian"), ("nbafl", "laplace")])
def test_dp_frames_match_jax(solution, mech, monkeypatch):
    """The singleton's local noise, global clip and global noise of each
    frame, clipping on, two calls each (the JAX draws carried)."""
    from fedml_tpu.core.dp.fedml_differential_privacy import \
        FedMLDifferentialPrivacy as J
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import \
        FedMLDifferentialPrivacy as T

    kw = dict(enable_dp=True, dp_solution_type=solution,
              dp_mechanism_type=mech, dp_epsilon=5.0, dp_delta=1e-5,
              dp_clip_norm=1.0, random_seed=7)
    raw = _lists()

    def run(cls, args, conv):
        dp = cls()
        dp.init(args().update(**kw))
        out = [dp.is_local_dp_enabled(), dp.is_global_dp_enabled()]
        for _ in range(2):
            if dp.is_local_dp_enabled():
                out.append(dp.add_local_noise(conv(raw[0][1])))
            out += [p for _, p in dp.global_clip(
                [(n, conv(p)) for n, p in raw])]
            if dp.is_global_dp_enabled():
                out.append(dp.add_global_noise(conv(raw[1][1])))
        return out

    got, want = _both(monkeypatch, lambda: run(J, j_arguments, _j),
                      lambda: run(T, t_arguments, _t))
    assert got[:2] == want[:2]
    assert len(got) == len(want)
    for g, w in zip(got[2:], want[2:]):
        _close(g, w)


def test_attacker_init_resets_unlike_the_jax_one():
    """A later run in the same process without ``enable_attack``: the
    port's attacker is off, the JAX one keeps the previous run's attacker
    (its ``init`` returns early without resetting).  Defender and DP reset
    in both."""
    from fedml_tpu.core.security.fedml_attacker import FedMLAttacker as J
    from fedml_tpu_torch.core.security.fedml_attacker import \
        FedMLAttacker as T

    on = dict(enable_attack=True, attack_type="byzantine")
    states = {}
    for pkg, cls, args in (("jax", J, j_arguments), ("port", T, t_arguments)):
        atk = cls()
        atk.init(args().update(**on))
        assert atk.is_model_attack()
        atk.init(args())
        states[pkg] = (atk.is_enabled, atk.is_model_attack())
    assert states["jax"] == (True, True)
    assert states["port"] == (False, False)


def _hook_classes(pkg):
    """A minimal ClientTrainer and FedAvg ServerAggregator of ``pkg``."""
    if pkg == "jax":
        from fedml_tpu.core.alg_frame.client_trainer import ClientTrainer
        from fedml_tpu.core.alg_frame.server_aggregator import \
            ServerAggregator
        from fedml_tpu.core.tree import weighted_average
    else:
        from fedml_tpu_torch.core.alg_frame.client_trainer import \
            ClientTrainer
        from fedml_tpu_torch.core.alg_frame.server_aggregator import \
            ServerAggregator
        from fedml_tpu_torch.core.tree import weighted_average

    class Trainer(ClientTrainer):
        params = None

        def get_model_params(self):
            return self.params

        def set_model_params(self, p):
            self.params = p

        def train(self, train_data, device, args):
            pass

    class Agg(ServerAggregator):
        params = None

        def get_model_params(self):
            return self.params

        def set_model_params(self, p):
            self.params = p

        def aggregate(self, raw):
            return weighted_average([p for _, p in raw], [n for n, _ in raw])

        def test(self, *a):
            return None

    return Trainer, Agg


def test_alg_frame_hooks_match_jax(monkeypatch):
    """The alg frame's hook pipeline with the attack, the defense and DP
    on: the client's label flipping before its pass, its local DP noise
    and byzantine corruption after; the server's attack injection, krum
    and global DP clip before its merge, the DP noise after."""
    kw = dict(enable_attack=True, attack_type="byzantine",
              attack_mode="random", byzantine_client_num=1,
              enable_defense=True, defense_type="krum", enable_dp=True,
              dp_solution_type="nbafl", dp_epsilon=20.0, dp_clip_norm=10.0,
              random_seed=4)
    raw = _lists(5)
    glob = _tree(np.random.default_rng(11))
    y = np.array([1, 2, 1, 0])

    def run(pkg):
        reset_singletons()
        args = (j_arguments if pkg == "jax" else t_arguments)().update(**kw)
        conv = _j if pkg == "jax" else _t
        Trainer, Agg = _hook_classes(pkg)
        agg = Agg(None, args)
        agg.set_model_params(conv(glob))
        before, _ = agg.on_before_aggregation([(n, conv(p)) for n, p in raw])
        merged = agg.on_after_aggregation(agg.aggregate(before))
        args = (j_arguments if pkg == "jax" else t_arguments)().update(
            **dict(kw, attack_type="label_flipping",
                   original_class_list=[1], target_class_list=[4]))
        tr = Trainer(None, args)
        data = tr.on_before_local_training((np.zeros(4), y), None, args)
        tr.set_model_params(conv(raw[0][1]))
        tr.on_after_local_training(data, None, args)
        return len(before), merged, data[1], tr.get_model_params()

    got, want = _both(monkeypatch, lambda: run("jax"), lambda: run("port"))
    reset_singletons()
    assert got[0] == want[0] == 1
    _close(got[1], want[1])
    assert np.array_equal(got[2], want[2]) and list(got[2]) == [4, 2, 4, 0]
    _close(got[3], want[3])
