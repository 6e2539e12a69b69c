"""Tag prediction (``lr`` on ``stackoverflow_lr``) and the tabular sets
against the JAX package's, on the CPU.

- Data: ``synthetic_tag_prediction`` and ``synthetic_tabular`` and every
  ``load()`` branch they feed (the capped synthetic fallback and its
  ``tag_count``/``feature_dim``/size overrides, the multi-hot ``.npz`` and
  its refusals, the tabular ``.npz``, the sklearn tables standardised
  with the train split's statistics) are bitwise equal to the JAX
  package's, partitions included.
- The loss and metrics: ``bce_elements``, ``bce_with_logits``,
  ``exact_match`` and ``exact_match_hits`` against the JAX functions to
  1e-6, logits of exactly 0 included (the reference's subgradient there is
  −t, which the port reproduces); the tag-prediction LR's logits and
  gradients against flax to 1e-5.
- Rounds: two FedAvg rounds against the JAX ``FedAvgAPI`` from the same
  weights, for ``lr`` on ``stackoverflow_lr``, ``uci`` and
  ``breast_cancer``: round losses and params within 1e-5, the test loss
  (per-example mean BCE for tag prediction) and accuracy (exact match)
  within 1e-5.
- ``tests/test_datasets_ext.py::test_real_tabular_federated_accuracy``'s
  bars on the port: accuracy ≥ 0.93 (breast cancer) and ≥ 0.80 (wine)
  after 15 rounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import data as j_data
from fedml_tpu import model as j_model
from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.data import synthetic as j_syn
from fedml_tpu.ml.trainer import local_trainer as j_lt
from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI

import fedml_tpu_torch
from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.data import synthetic as t_syn
from fedml_tpu_torch.ml.trainer import local_trainer as t_lt
from fedml_tpu_torch.models.convert import from_flax
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvgAPI

TOL = 1e-5


@pytest.mark.parametrize("seed,n_tags,n_feats", [(0, 20, 50), (5, 7, 33),
                                                 (2, 1, 10)])
def test_synthetic_tag_prediction_bitwise(seed, n_tags, n_feats):
    a = j_syn.synthetic_tag_prediction(60, 12, n_tags, n_feats, seed)
    b = t_syn.synthetic_tag_prediction(60, 12, n_tags, n_feats, seed)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("seed,classes,n_feats", [(0, 2, 14), (9, 3, 20)])
def test_synthetic_tabular_bitwise(seed, classes, n_feats):
    a = j_syn.synthetic_tabular(80, 20, classes, n_feats, seed)
    b = t_syn.synthetic_tabular(80, 20, classes, n_feats, seed)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


def _load_both(**over):
    over = dict(dict(client_num_in_total=5, random_seed=0,
                     data_cache_dir=""), **over)
    jargs, targs = j_arguments().update(**over), t_arguments().update(**over)
    jd, jn = j_data.load(jargs)
    td, tn = t_data.load(targs)
    assert jn == tn
    for name in ("train_x", "train_y", "test_x", "test_y"):
        a, b = getattr(jd, name), getattr(td, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert jd.provenance == td.provenance
    assert jd.client_idxs.keys() == td.client_idxs.keys()
    for c in jd.client_idxs:
        np.testing.assert_array_equal(jd.client_idxs[c], td.client_idxs[c])
    for key in ("input_shape", "task_type"):
        assert jargs.get(key) == targs.get(key), key
    return td, targs


@pytest.mark.parametrize("over,shape", [
    (dict(), (5000, 1000, 100)),
    (dict(tag_count=12, feature_dim=40, train_size=90, test_size=15,
          partition_method="homo"), (90, 40, 12)),
    (dict(tag_count=500, feature_dim=64, train_size=30, test_size=5,
          partition_alpha=0.3, random_seed=4), (30, 64, 500)),
])
def test_stackoverflow_lr_synthetic_bitwise(over, shape):
    td, args = _load_both(dataset="stackoverflow_lr", **over)
    assert (td.train_x.shape[0], td.train_x.shape[1], td.train_y.shape[1]) \
        == shape
    assert args.task_type == "tag_prediction"
    assert tuple(args.input_shape) == (shape[1],)
    assert td.provenance == "synthetic"
    if not over:
        assert td.test_x.shape[0] == 500   # the loader's cap


def test_stackoverflow_lr_npz_and_its_checks(tmp_path):
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "stackoverflow_lr.npz",
             train_x=rng.random((30, 16), np.float32),
             train_y=(rng.random((30, 6)) < 0.3).astype(np.int64),
             test_x=rng.random((6, 16), np.float32),
             test_y=(rng.random((6, 6)) < 0.3).astype(np.int64))
    td, args = _load_both(dataset="stackoverflow_lr",
                          data_cache_dir=str(tmp_path))
    assert td.provenance == "real:npz" and td.train_y.dtype == np.float32
    assert tuple(args.input_shape) == (16,)
    for bad in (dict(train_y=rng.integers(0, 6, 30)),
                dict(test_y=(rng.random((6, 5)) < 0.3).astype(np.int64))):
        d = tmp_path / f"bad{len(bad)}{sorted(bad)[0]}"
        d.mkdir()
        arrays = dict(train_x=rng.random((30, 16), np.float32),
                      train_y=(rng.random((30, 6)) < 0.3).astype(np.int64),
                      test_x=rng.random((6, 16), np.float32),
                      test_y=(rng.random((6, 6)) < 0.3).astype(np.int64))
        arrays.update(bad)
        np.savez(d / "stackoverflow_lr.npz", **arrays)
        msgs = []
        for pkg in (j_data, t_data):
            args = (j_arguments if pkg is j_data else t_arguments)().update(
                dataset="stackoverflow_lr", data_cache_dir=str(d))
            with pytest.raises(ValueError) as err:
                pkg.load(args)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("over", [
    dict(dataset="uci", train_size=120, test_size=30),
    dict(dataset="uci_adult", train_size=64, test_size=16,
         partition_method="homo"),
    dict(dataset="lending_club", train_size=100, test_size=20,
         random_seed=3),
    dict(dataset="lending_club_loan", train_size=50, test_size=10,
         partition_alpha=0.2),
])
def test_tabular_synthetic_bitwise(over):
    td, _ = _load_both(**over)
    assert td.provenance == "synthetic"


def test_tabular_npz_bitwise(tmp_path):
    rng = np.random.default_rng(2)
    np.savez(tmp_path / "uci.npz", train_x=rng.random((40, 14), np.float32),
             train_y=rng.integers(0, 2, 40),
             test_x=rng.random((10, 14), np.float32),
             test_y=rng.integers(0, 2, 10))
    td, _ = _load_both(dataset="uci", data_cache_dir=str(tmp_path))
    assert td.provenance == "real:npz"


@pytest.mark.parametrize("over", [
    dict(dataset="breast_cancer"), dict(dataset="wine", random_seed=2),
    dict(dataset="uci_real", train_size=300, partition_method="homo"),
    dict(dataset="wine", train_size=100000, client_num_in_total=8)])
def test_sklearn_tables_bitwise(over):
    pytest.importorskip("sklearn")
    td, _ = _load_both(**over)
    assert td.provenance.startswith("real:sklearn-")
    # standardised with the train split's statistics
    np.testing.assert_allclose(td.train_x.mean(0), 0, atol=1e-5)


def test_bce_and_exact_match_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 9)).astype(np.float32)
    logits[0, :4] = 0.0                      # ties at 0
    targets = (rng.random((6, 9)) < 0.3).astype(np.float32)
    targets[1] = (logits[1] > 0)             # an exact hit
    jl, jt = jnp.asarray(logits), jnp.asarray(targets)
    tl, tt = torch.tensor(logits), torch.tensor(targets)
    for fn in ("bce_elements", "bce_with_logits", "exact_match_hits",
               "exact_match"):
        np.testing.assert_allclose(getattr(t_lt, fn)(tl, tt).numpy(),
                                   np.asarray(getattr(j_lt, fn)(jl, jt)),
                                   rtol=0, atol=1e-6, err_msg=fn)
    jg = jax.grad(lambda l: j_lt.bce_with_logits(l, jt))(jl)
    tg = torch.func.grad(lambda l: t_lt.bce_with_logits(l, tt))(tl)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-7)
    assert float(t_lt.exact_match_hits(tl, tt)[1]) == 1.0


def test_tag_prediction_lr_matches_flax():
    over = dict(model="lr", dataset="stackoverflow_lr", input_shape=(24,))
    jm = j_model.create(j_arguments().update(**over), 10)
    tm = t_model.create(t_arguments().update(**over), 10)
    assert tm.task == jm.task == "tag_prediction"
    jp = jax.device_get(jm.init(jax.random.PRNGKey(1)))
    tp = from_flax(jp, tm, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.random((5, 24), np.float32)
    y = (rng.random((5, 10)) < 0.3).astype(np.float32)
    jl, jg = jax.value_and_grad(
        lambda p: j_lt.bce_with_logits(jm.apply(p, jnp.asarray(x)),
                                       jnp.asarray(y)))(jp)
    tg, tl = torch.func.grad_and_value(
        lambda p: t_lt.bce_with_logits(tm.apply(p, torch.tensor(x)),
                                       torch.tensor(y)))(tp)
    assert abs(float(tl) - float(jl)) < TOL
    ref = from_flax(jax.device_get(jg), tm, device="cpu")
    for k in tp:
        np.testing.assert_allclose(tg[k].numpy(), ref[k].numpy(), rtol=0,
                                   atol=TOL, err_msg=k)


ROUNDS = {
    "stackoverflow_lr": dict(dataset="stackoverflow_lr", train_size=200,
                             test_size=40, tag_count=20, feature_dim=50,
                             learning_rate=0.5),
    "uci": dict(dataset="uci", input_shape=(14,), train_size=200,
                test_size=40, learning_rate=0.1),
    "breast_cancer": dict(dataset="breast_cancer", input_shape=(30,),
                          learning_rate=0.1, train_size=100000),
}


@pytest.mark.parametrize("ds", sorted(ROUNDS))
def test_lr_rounds_match_jax(ds):
    if ds == "breast_cancer":
        pytest.importorskip("sklearn")
    cfg = dict(ROUNDS[ds], model="lr", client_num_in_total=5,
               client_num_per_round=3, batch_size=8, comm_round=2, epochs=1,
               frequency_of_the_test=10 ** 9, random_seed=0)
    jargs = j_arguments().update(**cfg)
    jds, jn = j_data.load(jargs)
    japi = JFedAvgAPI(jargs, None, jds, j_model.create(jargs, jn))
    targs = t_arguments().update(**cfg)
    tds, tn = t_data.load(targs)
    tm = t_model.create(targs, tn)
    assert tm.task == ("tag_prediction" if ds == "stackoverflow_lr"
                       else "classification")
    tapi = TFedAvgAPI(targs, "cpu", tds, tm)
    tapi.state = tapi.state.replace(global_params=from_flax(
        jax.device_get(japi.state.global_params), tm, device="cpu"))
    for r in range(2):
        jm, tmr = japi.train_one_round(r), tapi.train_one_round(r)
        assert float(tmr["total_steps"]) == float(jm["total_steps"])
        assert abs(float(tmr["train_loss"]) - float(jm["train_loss"])) < TOL
    ref = from_flax(jax.device_get(japi.state.global_params), tm,
                    device="cpu")
    for k, v in tapi.state.global_params.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0,
                                   atol=TOL, err_msg=k)
    (jl, ja), (tl, ta) = japi.evaluate(), tapi.evaluate()
    assert abs(tl - jl) < TOL and abs(ta - ja) < TOL, ((jl, ja), (tl, ta))


@pytest.mark.parametrize("name,feats,clients,floor", [
    ("breast_cancer", 30, 10, 0.93), ("wine", 13, 8, 0.80)])
def test_real_tabular_federated_accuracy(name, feats, clients, floor):
    """Mirror of ``tests/test_datasets_ext.py::
    test_real_tabular_federated_accuracy`` through ``run_simulation`` on
    the CPU: federated LR on sklearn's tables after 15 rounds."""
    pytest.importorskip("sklearn")
    args = t_arguments().update(
        dataset=name, model="lr", input_shape=(feats,),
        client_num_in_total=clients, client_num_per_round=max(2,
                                                              clients // 2),
        comm_round=15, epochs=1, batch_size=8, learning_rate=0.1,
        partition_method="hetero", partition_alpha=0.5,
        frequency_of_the_test=100, random_seed=0, train_size=100000)
    params = fedml_tpu_torch.run_simulation(backend="sp", args=args,
                                            device="cpu")
    ds, out_dim = t_data.load(args)
    assert ds.provenance.startswith("real:sklearn-")
    assert ds.train_x.shape[1] == feats
    assert out_dim == (2 if name == "breast_cancer" else 3)
    trainer = t_lt.LocalTrainer(t_model.create(args, out_dim), args)
    _, acc = trainer.evaluate(params, *ds.test_batches())
    assert acc >= floor, (name, acc)
