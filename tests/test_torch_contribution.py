"""The port's contribution assessors against the JAX package's, on the CPU.

GTG-Shapley, MR-Shapley (exact, and sampled above ``mr_exact_limit``) and
leave-one-out run the same client list through both packages with one
continuous utility (a float64 numpy function of the merged params): the
permutations are the same host streams, so φ agrees within ``TOL``.  The
cross-silo server credits a round's silos through a user
``ServerAggregator``; the JAX aggregator hands its assessors the params
without their sample counts (they then fail to unpack them), so the JAX
witness's aggregator pairs each params with its count, as the port's
server does."""

import logging

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu_torch.arguments import load_arguments as t_arguments

from .torch_cross_silo_parity import LR, jax_federation, port_federation
from .torch_trust_parity import fedavg_aggregator, reset_singletons, silos

TOL = 1e-6

ALGS = {"gtg": ("gtg_shapley", "GTGShapleyValue"),
        "mr": ("mr_shapley", "MRShapleyValue"),
        "loo": ("loo", "LeaveOneOut")}


def _assessor(pkg, alg, **over):
    import importlib
    mod, cls = ALGS[alg]
    root = "fedml_tpu" if pkg == "jax" else "fedml_tpu_torch"
    m = importlib.import_module(f"{root}.core.contribution.{mod}")
    load = j_arguments if pkg == "jax" else t_arguments
    return getattr(m, cls)(load().update(**over))


def _models(n=5, seed=0):
    rng = np.random.default_rng(seed)
    target = {"b": rng.normal(size=3), "w": rng.normal(size=(4, 3))}
    out = []
    for i in range(n):
        spread = 0.2 * (i + 1)
        out.append((10.0 + 3 * i, {
            k: (v + spread * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in target.items()}))
    return out, target


def _val_fn(target):
    def val(params):
        return -float(sum(np.mean((np.asarray(params[k], np.float64) - v)
                                  ** 2) for k, v in target.items()))
    return val


@pytest.mark.parametrize("alg, over", [
    ("gtg", {}), ("gtg", dict(gtg_eps=0.5, gtg_max_perms=4)),
    ("mr", {}), ("mr", dict(mr_exact_limit=3, mr_sample_perms=7)),
    ("loo", {})])
def test_assessors_match_jax(alg, over):
    models, target = _models()
    idxs = [3, 1, 4, 0, 2]
    j_models = [(n, {k: jax.numpy.asarray(v) for k, v in p.items()})
                for n, p in models]
    t_models = [(n, {k: torch.from_numpy(v) for k, v in p.items()})
                for n, p in models]
    val = _val_fn(target)
    want = _assessor("jax", alg, random_seed=5, **over).compute(
        idxs, j_models, None, val)
    got = _assessor("port", alg, random_seed=5, **over).compute(
        idxs, t_models, None, val)
    assert list(got) == list(want)
    for c in want:
        assert abs(got[c] - want[c]) <= TOL, (c, got[c], want[c])
    if alg == "mr" and not over:
        # exact enumeration: efficiency, Σφ = U(all) − U(∅), U(all) as the
        # assessor first merges it (client 0 last: S = {1..4}, then k = 0)
        from fedml_tpu_torch.core.tree import weighted_average
        order = t_models[1:] + t_models[:1]
        u_all = val(weighted_average([p for _, p in order],
                                     [n for n, _ in order]))
        assert abs(sum(got.values()) - u_all) <= 1e-9


def test_assessors_rank_honest_clients():
    """The JAX package's honest-ranking test, on the port."""
    target = torch.ones(10)
    models = [(1.0, {"w": target.clone()}), (1.0, {"w": target.clone()}),
              (1.0, {"w": -3 * target})]

    def val_fn(params):
        return -float(torch.mean((params["w"] - target) ** 2))

    for alg in ALGS:
        phi = _assessor("port", alg).compute([0, 1, 2], models, None, val_fn)
        assert phi[0] > phi[2] and phi[1] > phi[2], (alg, phi)


def test_manager_dispatches_by_name():
    from fedml_tpu_torch.core.contribution.contribution_assessor_manager \
        import ContributionAssessorManager
    from fedml_tpu_torch.core.contribution.gtg_shapley import \
        GTGShapleyValue
    from fedml_tpu_torch.core.contribution.loo import LeaveOneOut
    from fedml_tpu_torch.core.contribution.mr_shapley import MRShapleyValue

    def build(**kw):
        return ContributionAssessorManager(t_arguments().update(**kw))

    assert build().get_assessor() is None
    for name, cls in (("GTG", GTGShapleyValue), (" mr ", MRShapleyValue),
                      ("LOO", LeaveOneOut)):
        assert isinstance(build(enable_contribution=True,
                                contribution_alg=name).get_assessor(), cls)
    assert isinstance(build(enable_contribution=True).get_assessor(),
                      GTGShapleyValue)
    with pytest.raises(ValueError, match="shap"):
        build(enable_contribution=True, contribution_alg="shap")
    out = {}
    build().run([0], [(1.0, {})], None, None, out)
    assert out == {}


def _jax_paired_aggregator(history):
    """The JAX FedAvg aggregator whose ``assess_contribution`` pairs the
    params it is given with the round's sample counts."""
    base = fedavg_aggregator("jax", history)

    class Paired(base):
        def aggregate(self, raw_list):
            self._counts = [n for n, _ in raw_list]
            return super().aggregate(raw_list)

        def assess_contribution(self, client_idxs, model_list,
                                aggregated_model, val_fn):
            return super().assess_contribution(
                client_idxs, list(zip(self._counts, model_list)),
                aggregated_model, val_fn)

    return Paired


@pytest.fixture
def _singletons():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_singletons()
    yield
    reset_singletons()
    torch.set_num_threads(before)


def test_cross_silo_round_credits_the_silos_as_jax(_singletons):
    cfg = dict(silos(LR, 3, train_size=240), comm_round=1,
               enable_contribution=True, contribution_alg="mr")
    hist = {"jax": [], "port": []}
    jx = jax_federation(cfg, "local", "tc_jax",
                        agg_factory=lambda m, a: _jax_paired_aggregator(
                            hist["jax"])(m, a))
    reset_singletons()
    pt = port_federation(cfg, "local", "tc_port", init=jx["init"],
                         agg_factory=lambda m, a: fedavg_aggregator(
                             "port", hist["port"])(m, a))
    want = jx["server"].aggregator.user_aggregator \
        .final_contribution_assigned_by_group
    got = pt["server"].aggregator.user_aggregator \
        .final_contribution_assigned_by_group
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for c in want:
        assert abs(got[c] - want[c]) <= TOL, (c, got, want)


def test_a_filtered_cohort_skips_the_assessment(_singletons, caplog):
    """Krum keeps one silo of three: the positions no longer name the
    silos, so nothing is credited, with a warning."""
    cfg = dict(silos(LR, 3, train_size=240), comm_round=1,
               enable_contribution=True, contribution_alg="loo",
               enable_defense=True, defense_type="krum",
               byzantine_client_num=1)
    with caplog.at_level(logging.WARNING):
        pt = port_federation(cfg, "local", "tc_filtered",
                             agg_factory=lambda m, a: fedavg_aggregator(
                                 "port", [])(m, a))
    ua = pt["server"].aggregator.user_aggregator
    assert ua.contribution_assessor_mgr.get_assessor() is not None
    assert ua.final_contribution_assigned_by_group == {}
    assert any("skipping contribution assessment" in r.message
               for r in caplog.records)
