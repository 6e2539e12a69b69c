"""The port's robust-aggregation defenses against the JAX package's, on
the CPU.

Every registered defense name runs two rounds on the same numpy client
lists in both packages (the JAX trust tests' ``_client_list`` recipe on a
two-leaf tree: eight clients at a common base, two of them shifted by
+100, and in the second round the two shifted clients turned against
their first-round direction, which stateful defenses such as
``cross_round``, ``foolsgold`` and ``cclip`` must see).  Each phase runs
as ``BaseDefense.run`` runs it, and the kept or selected client positions
must be equal, the merged rows within ``MERGE_TOL``.  The noising
defenses (``weak_dp``, ``crfl``) draw the JAX package's own draws
(``tests/torch_trust_parity.py``).  A row of a model's params is the JAX
row element for element (the layout registry of ``common.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.core.security import defense as j_defense
from fedml_tpu.core.tree import tree_flatten_1d as j_flatten
from fedml_tpu.core.tree import weighted_average as j_wavg

from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.core.security import defense as t_defense
from fedml_tpu_torch.core.security.defense import common as t_common
from fedml_tpu_torch.core.tree import weighted_average as t_wavg

from .torch_trust_parity import record_jax_draws, replay_draws

#: merged rows: relative and absolute bar (f32 sums in another order)
MERGE_TOL = 1e-6

#: FoolsGold's merge is ill-conditioned on these near-parallel clients:
#: its weights are logits of 1 − max cosine (~1e-4 here), so one f32 ulp
#: of a cosine moves the merge by ~1e-6 and the two packages' f32 merges
#: part by ~7e-6.  Both are held instead to the same algorithm in float64
#: (the witness), within this many times the witness's own change when
#: every client's max cosine moves by one f32 ulp (2**-24), plus
#: MERGE_TOL relative and absolute.
ULP_FACTOR = 8.0

#: the JAX trust tests' defense arguments
ARGS = dict(byzantine_client_num=2, trimmed_mean_beta=0.3, trim_param_b=2,
            slsgd_alpha=0.5, norm_bound=1.0, robust_threshold=4,
            random_seed=3)


def _rounds(n=8, bad=(0, 1), seed=0):
    """Two rounds of ``n`` clients' two-leaf trees as numpy: ``{"b": (4,),
    "w": (4, 4)}`` around a common base, ``bad`` shifted by +100; the
    second round's ``bad`` clients negated.  Also the base."""
    rng = np.random.default_rng(seed)
    base = {"b": rng.normal(size=4).astype(np.float32),
            "w": rng.normal(size=(4, 4)).astype(np.float32)}
    rounds = []
    for r in range(2):
        lst = []
        for i in range(n):
            p = {k: v + 0.01 * rng.normal(size=v.shape).astype(np.float32)
                 for k, v in base.items()}
            if i in bad:
                p = {k: v + 100.0 for k, v in p.items()}
                if r == 1:
                    p = {k: -v for k, v in p.items()}
            lst.append((10.0 + i, p))
        rounds.append(lst)
    return rounds, base


def _run(pkg, d, raw, extra):
    """``BaseDefense.run`` phase by phase: (kept positions or None, the
    merge)."""
    wavg = j_wavg if pkg == "jax" else t_wavg
    merge = lambda lst: wavg([p for _, p in lst], [n for n, _ in lst])
    lst, kept = raw, None
    if hasattr(d, "defend_before_aggregation"):
        lst = d.defend_before_aggregation(raw, extra)
        ids = {id(e): i for i, e in enumerate(raw)}
        if all(id(e) in ids for e in lst):
            kept = [ids[id(e)] for e in lst]
    if hasattr(d, "defend_on_aggregation"):
        out = d.defend_on_aggregation(lst, merge, extra)
    else:
        out = merge(lst)
        if hasattr(d, "defend_after_aggregation"):
            out = d.defend_after_aggregation(out)
    return kept, out, lst


def _foolsgold_f64(rounds_lists, bump=None):
    """The JAX FoolsGold merge of each round in float64 numpy (the
    witness of its f32 rounding); ``bump`` is added to the last round's
    max cosines."""
    hist, outs = None, []
    for r, lst in enumerate(rounds_lists):
        vecs = np.stack([np.concatenate([p[k].astype(np.float64).ravel()
                                         for k in sorted(p)])
                         for _, p in lst])
        w = np.array([n for n, _ in lst], np.float64)
        hist = vecs if hist is None else hist + vecs
        normed = hist / np.maximum(np.linalg.norm(hist, axis=1,
                                                  keepdims=True), 1e-12)
        cs = normed @ normed.T - np.eye(len(lst))
        maxcs = cs.max(axis=1)
        if bump is not None and r == len(rounds_lists) - 1:
            maxcs = maxcs + bump
        mc = np.clip(maxcs, 1e-6, 1 - 1e-6)
        wv = 1.0 - mc
        wv = np.clip(wv / wv.max(), 1e-6, 1 - 1e-6)
        wv = np.clip(np.log(wv / (1 - wv)) / 4.0 + 0.5, 0.0, 1.0)
        agg = (wv * w / np.sum(wv * w + 1e-12)) @ vecs
        outs.append({"b": agg[:4], "w": agg[4:].reshape(4, 4)})
    return outs


def _foolsgold_bar(rounds_lists):
    """The f64 witness of the last round and its one-ulp sensitivity:
    the summed change of the merge when each client's max cosine moves by
    2**-24."""
    wit = _foolsgold_f64(rounds_lists)[-1]
    n = len(rounds_lists[-1])
    sens = {k: np.zeros_like(v) for k, v in wit.items()}
    for c in range(n):
        bump = np.zeros(n)
        bump[c] = 2.0 ** -24
        moved = _foolsgold_f64(rounds_lists, bump)[-1]
        for k in sens:
            sens[k] += np.abs(moved[k] - wit[k])
    return wit, {k: ULP_FACTOR * np.max(v) + MERGE_TOL * (1 + np.abs(wit[k]))
                 for k, v in sens.items()}


def _host(tree):
    return {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                          else v) for k, v in tree.items()}


@pytest.mark.parametrize("name", t_defense.registered_names())
def test_every_defense_matches_jax(name, monkeypatch):
    draws = record_jax_draws(monkeypatch)
    rounds, base = _rounds()
    jd = j_defense.create_defender(name, j_arguments().update(
        defense_type=name, **ARGS))
    td = t_defense.create_defender(name, t_arguments().update(
        defense_type=name, **ARGS))
    j_extra = {k: jnp.asarray(v) for k, v in base.items()}
    t_extra = {k: torch.tensor(v) for k, v in base.items()}
    jax_out = []
    for raw in rounds:
        jraw = [(n, {k: jnp.asarray(v) for k, v in p.items()})
                for n, p in raw]
        jax_out.append(_run("jax", jd, jraw, j_extra))
    replay_draws(monkeypatch, draws)
    for r, raw in enumerate(rounds):
        traw = [(n, {k: torch.tensor(v) for k, v in p.items()})
                for n, p in raw]
        kept, out, lst = _run("port", td, traw, t_extra)
        jkept, jout, jlst = jax_out[r]
        assert kept == jkept, (name, r, kept, jkept)
        assert len(lst) == len(jlst)
        for (n, p), (jn, jp) in zip(lst, jlst):
            assert n == jn
            for k, v in _host(p).items():
                np.testing.assert_allclose(v, np.asarray(jp[k]),
                                           rtol=MERGE_TOL, atol=MERGE_TOL)
        got, want = _host(out), _host(jout)
        assert list(got) == list(want)
        for k in got:
            assert got[k].shape == want[k].shape
            if name == "foolsgold":
                wit, bar = _foolsgold_bar(rounds[:r + 1])
                for pkg, v in (("port", got[k]), ("jax", want[k])):
                    assert np.all(np.abs(v - wit[k]) <= bar[k]), \
                        (pkg, r, k, np.abs(v - wit[k]), bar[k])
                continue
            np.testing.assert_allclose(got[k], want[k], rtol=MERGE_TOL,
                                       atol=MERGE_TOL, err_msg=(name, r, k))
    assert not any(draws.values()), "JAX drew noise the port did not"


def test_the_registries_name_the_same_defenses():
    j_defense.create_defender("krum", j_arguments())
    assert t_defense.registered_names() == sorted(j_defense._REGISTRY)


def test_cross_round_filters_the_flipped_clients_in_both():
    """The JAX test's scenario: no history in round 1 (all six kept),
    two clients flip direction in round 2 and are filtered."""
    rounds, _ = _rounds(6, bad=())
    kept = {}
    for pkg, create, args, conv in (
            ("jax", j_defense.create_defender, j_arguments, jnp.asarray),
            ("port", t_defense.create_defender, t_arguments, torch.tensor)):
        d = create("cross_round", args().update(
            defense_type="cross_round"))
        raw1 = [(n, {k: conv(v) for k, v in p.items()})
                for n, p in rounds[0]]
        raw2 = [(n, {k: -v for k, v in p.items()}) if i < 2 else (n, p)
                for i, (n, p) in enumerate(raw1)]
        kept[pkg] = (len(d.defend_before_aggregation(raw1)),
                     len(d.defend_before_aggregation(raw2)),
                     list(d.last_flagged))
    assert kept["jax"] == kept["port"] == (6, 4, [0, 1])


def test_defense_filters_byzantine_as_in_the_jax_test():
    """The JAX test's bar on the port alone: every distance and statistics
    defense lands within 5 of the honest base with 2 of 8 clients shifted
    by +100 (the naive mean is ~25 away)."""
    rounds, base = _rounds()
    for name in ("krum", "multi_krum", "bulyan", "coordinate_wise_median",
                 "trimmed_mean", "rfa", "foolsgold",
                 "residual_based_reweighting", "slsgd", "wbc", "three_sigma",
                 "three_sigma_geomedian", "three_sigma_krum"):
        d = t_defense.create_defender(name, t_arguments().update(
            defense_type=name, **dict(ARGS, slsgd_alpha=1.0)))
        raw = [(n, {k: torch.tensor(v) for k, v in p.items()})
               for n, p in rounds[0]]
        merged = d.run(raw, base_agg=t_common.merge_list)
        err = max(float(torch.max(torch.abs(merged[k] - torch.tensor(v))))
                  for k, v in base.items())
        assert err < 5.0, (name, err)


def test_a_model_row_is_the_jax_row():
    """A registered model's params flatten in the JAX leaf order and
    layout (``Dense`` kernels ``(in, out)``): the port's row of ``lr``'s
    params is bitwise the JAX ``tree_flatten_1d`` of the same weights, and
    ``unstack_to_list`` gives the port's leaves back."""
    import jax

    from fedml_tpu import model as j_model
    from fedml_tpu_torch import model as t_model
    from fedml_tpu_torch.models.convert import from_flax

    cfg = dict(dataset="synthetic", num_classes=10, input_shape=(8, 8, 1),
               model="lr")
    ja = j_arguments().update(**cfg)
    jm = j_model.create(ja, 10)
    jp = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    tm = t_model.create(t_arguments().update(**cfg), 10)
    tp = from_flax(jp, tm, device="cpu")
    t_common.use_layout(tm)
    row = t_common.tree_flatten_1d(tp)
    assert np.array_equal(row.numpy(), np.asarray(j_flatten(jp)))
    vecs, w, tmpl = t_common.stack_clients([(2.0, tp), (3.0, tp)])
    back = t_common.unstack_to_list(vecs, w, tmpl)
    assert [n for n, _ in back] == [2.0, 3.0]
    assert list(back[1][1]) == list(tp)
    for k in tp:
        assert torch.equal(back[1][1][k], tp[k]), k
