"""The LSTM language models, the ``"lm"`` task and the LM loader branch
against the JAX package's, on the CPU.

- Models: ``RNNOriginalFedAvg`` at its full reference width (Embed(90, 8)
  → 2 × LSTM(256) → Dense(90), seq 80) and ``RNNStackOverflow`` (Embed 96
  → LSTM(670) → Dense(96) → Dense(vocab); a 50-token vocabulary and seq 6
  here), at the same weights (``models/convert.py``) on the same tokens:
  logits, the mean cross-entropy over every position and its gradient with
  respect to every parameter within 1e-5 (absolute, and relative to the
  largest entry of the tensor).
- Rounds: two FedAvg rounds of ``rnn`` on ``shakespeare`` and of
  ``rnn_stackoverflow`` on ``stackoverflow_nwp`` (synthetic Markov-chain
  tokens) against the JAX ``FedAvgAPI`` from the same weights: round losses
  and params within 1e-5; the test loss and accuracy (per-position means
  per example, then over examples) within 1e-5.
- The cohort map: the vmapped round ≡ the per-client loop to 1e-6.
- Data: the raw-text, LEAF and ``.npz`` Shakespeare reads, bitwise equal.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import data as j_data
from fedml_tpu import model as j_model
from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.data import leaf as j_leaf
from fedml_tpu.data.leaf import ALL_LETTERS, encode_chars
from fedml_tpu.ml.trainer.local_trainer import cross_entropy_loss as j_xent
from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI

from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.core import rng as t_rng
from fedml_tpu_torch.data import leaf as t_leaf
from fedml_tpu_torch.ml.trainer.local_trainer import \
    cross_entropy_loss as t_xent
from fedml_tpu_torch.models.convert import from_flax, to_flax
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvgAPI

TOL = 1e-5


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Small shapes: two intra-op threads avoid oversubscribing the cores
    when several test processes share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want, what, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _models(name, vocab, seq):
    cfg = dict(model=name, dataset="x", seq_len=seq)
    return (j_model.create(j_arguments().update(**cfg), vocab),
            t_model.create(t_arguments().update(**cfg), vocab))


@pytest.mark.parametrize("name,vocab,seq,n_params", [
    ("rnn", 90, 80, 820522), ("rnn_stackoverflow", 50, 6, None)])
def test_forward_and_gradients_match_flax(name, vocab, seq, n_params):
    jm, tm = _models(name, vocab, seq)
    assert tm.task == jm.task == "lm" and tm.input_dtype == torch.int32
    jp = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    tp = from_flax(jp, tm, device="cpu")
    if n_params:
        assert sum(v.numel() for v in tp.values()) == n_params
    rng = np.random.default_rng(0)
    x, y = rng.integers(0, vocab, (2, seq)), rng.integers(0, vocab, (2, seq))

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(x, jnp.int32))
        return j_xent(logits, jnp.asarray(y)), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)

    def tloss(p):
        logits = tm.apply(p, torch.tensor(x, dtype=torch.int32))
        return t_xent(logits, torch.tensor(y)), logits

    tg, (tl, tlogits) = torch.func.grad_and_value(tloss, has_aux=True)(tp)
    _close(tlogits, jlogits, "logits")
    _close(tl, jl, "loss")
    ref = from_flax(jax.device_get(jg), tm, device="cpu")
    for k in tp:
        _close(tg[k], ref[k].numpy(), f"grad {k}")


def test_stackoverflow_width_and_flax_names():
    """``rnn_stackoverflow`` at its reference vocabulary has flax's 4,050,748
    parameters, under flax's names (``if`` through ``flax_names``), and the
    weights carry both ways bitwise."""
    jm, tm = _models("rnn_stackoverflow", 10004, 20)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    tp = from_flax(jp, tm, device="cpu")
    assert sum(v.numel() for v in tp.values()) == 4050748
    assert "_LSTMStack_0.lstm_0.in_f.weight" in tp
    back = to_flax(tp, tm)
    assert sorted(back["_LSTMStack_0"]["lstm_0"]) == sorted(
        ["ii", "if", "ig", "io", "hi", "hf", "hg", "ho"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_port_init_follows_flax_initialisers():
    """The port's own init: lecun-normal input kernels, orthogonal hidden
    kernels (W·Wᵀ = I), zero biases, the embedding's normal of std
    1/√features."""
    _, tm = _models("rnn", 90, 80)
    p = tm.init(t_rng.purpose_key(t_rng.root_key(0), "init"))
    cell = "_LSTMStack_0.lstm_1."
    for g in "ifgo":
        w = p[cell + f"hid_{g}.weight"]
        torch.testing.assert_close(w @ w.T, torch.eye(256), atol=1e-5,
                                   rtol=0)
        assert torch.count_nonzero(p[cell + f"hid_{g}.bias"]) == 0
        w_in = p[cell + f"in_{g}.weight"]
        assert abs(float(w_in.std()) * 16 - 1) < 0.05   # std 1/√256
    assert abs(float(p["Embed_0.weight"].std()) * 8 ** 0.5 - 1) < 0.1


def _pair(cfg, mode="vmap"):
    jargs = j_arguments().update(**cfg)
    jds, jn = j_data.load(jargs)
    japi = JFedAvgAPI(jargs, None, jds, j_model.create(jargs, jn))
    targs = t_arguments().update(**cfg)
    tds, tn = t_data.load(targs)
    tm = t_model.create(targs, tn)
    tapi = TFedAvgAPI(targs, "cpu", tds, tm, client_mode=mode)
    tapi.state = tapi.state.replace(global_params=from_flax(
        jax.device_get(japi.state.global_params), tm, device="cpu"))
    return japi, tapi


LM_ROUNDS = {
    "shakespeare": dict(model="rnn", dataset="shakespeare", seq_len=10,
                        train_size=120, test_size=24),
    "stackoverflow_nwp": dict(model="rnn_stackoverflow",
                              dataset="stackoverflow_nwp", seq_len=6,
                              train_size=64, test_size=16),
}


def _lm_cfg(ds, **over):
    return dict(LM_ROUNDS[ds], client_num_in_total=4, client_num_per_round=2,
                batch_size=5, learning_rate=0.5, comm_round=2, epochs=1,
                frequency_of_the_test=10 ** 9, random_seed=0, **over)


@pytest.mark.parametrize("ds", sorted(LM_ROUNDS))
def test_lm_rounds_match_jax(ds):
    japi, tapi = _pair(_lm_cfg(ds))
    assert tapi.model.task == "lm"
    for r in range(2):
        jm, tm = japi.train_one_round(r), tapi.train_one_round(r)
        assert float(tm["total_steps"]) == float(jm["total_steps"])
        assert abs(float(tm["train_loss"]) - float(jm["train_loss"])) < TOL
    ref = from_flax(jax.device_get(japi.state.global_params), tapi.model,
                    device="cpu")
    for k, v in tapi.state.global_params.items():
        _close(v, ref[k].numpy(), k)
    # the per-position means per example, then over the test examples
    (jl, ja), (tl, ta) = japi.evaluate(), tapi.evaluate()
    assert abs(tl - jl) < TOL and abs(ta - ja) < TOL, ((jl, ja), (tl, ta))


def test_lm_eval_takes_per_position_means():
    """The LM eval step on a ragged tail: each valid example's loss and
    hits are its means over the positions; padded rows count nothing."""
    _, tm = _models("rnn", 12, 5)
    from fedml_tpu_torch.ml.trainer.local_trainer import LocalTrainer
    args = t_arguments().update(model="rnn", seq_len=5)
    trainer = LocalTrainer(tm, args)
    p = tm.init(t_rng.root_key(1))
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.integers(0, 12, (4, 5)))
    y = torch.tensor(rng.integers(0, 12, (4, 5)))
    m = torch.tensor([1.0, 1.0, 1.0, 0.0])
    loss, hits, n = trainer.make_eval_step()(p, x, y, m)
    logp = torch.log_softmax(tm.apply(p, x), -1)
    ll = torch.gather(logp, -1, y[..., None])[..., 0]
    hit = (logp.argmax(-1) == y).float()
    assert float(n) == 3
    torch.testing.assert_close(loss, -ll[:3].mean(1).sum())
    torch.testing.assert_close(hits, hit[:3].mean(1).sum())


def test_vmapped_lstm_round_matches_the_client_loop():
    """The hand-written cell batches under ``torch.func.vmap``: a vmapped
    cohort's round equals the per-client loop's to 1e-6."""
    cfg = _lm_cfg("shakespeare")
    _, vm = _pair(cfg, "vmap")
    _, sc = _pair(cfg, "scan")
    for r in range(2):
        a, b = vm.train_one_round(r), sc.train_one_round(r)
        assert abs(float(a["train_loss"]) - float(b["train_loss"])) < 1e-6
    for k, v in vm.state.global_params.items():
        _close(v, sc.state.global_params[k].numpy(), k, tol=1e-6)


def _same_lm_dataset(over):
    over = dict(dict(client_num_in_total=4, random_seed=0), **over)
    jd, jn = j_data.load(j_arguments().update(**over))
    td, tn = t_data.load(t_arguments().update(**over))
    assert jn == tn
    for name in ("train_x", "train_y", "test_x", "test_y"):
        a, b = getattr(jd, name), getattr(td, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert jd.provenance == td.provenance
    assert jd.client_idxs.keys() == td.client_idxs.keys()
    for c in jd.client_idxs:
        np.testing.assert_array_equal(jd.client_idxs[c], td.client_idxs[c])
    for c in (jd.test_client_idxs or {}):
        np.testing.assert_array_equal(jd.test_client_idxs[c],
                                      td.test_client_idxs[c])
    assert (jd.test_client_idxs is None) == (td.test_client_idxs is None)
    return td


def test_leaf_char_encoding():
    """Mirror of ``tests/test_datasets_ext.py::test_leaf_char_encoding``:
    the reference letter table, padding and the unknown character."""
    ids = t_leaf.encode_chars("The }", seq_len=8)
    assert ids == encode_chars("The }", seq_len=8)
    assert ids[0] == ALL_LETTERS.index("T") + 1
    assert ids[4] == ALL_LETTERS.index("}") + 1
    assert ids[5:] == [0, 0, 0]
    assert t_leaf.encode_chars("\x00", seq_len=1) == [0]
    assert t_leaf.ALL_LETTERS == ALL_LETTERS


CORPUS = ("To be, or not to be, that is the question:\n"
          "Whether 'tis nobler in the mind to suffer\n" * 120)


@pytest.mark.parametrize("where", ["shakespeare.txt",
                                   "fed_shakespeare/shakespeare.txt",
                                   "shakespeare/shakespeare.txt"])
def test_shakespeare_raw_text_ingestion(tmp_path, where):
    """Mirror of ``tests/test_datasets_ext.py::
    test_shakespeare_raw_text_ingestion`` over the three paths the loader
    searches: the arrays bitwise the JAX package's, x shifted by one is y,
    and the windows decode to the corpus."""
    path = tmp_path / where
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(CORPUS)
    td = _same_lm_dataset(dict(dataset="fed_shakespeare",
                               data_cache_dir=str(tmp_path), seq_len=20))
    assert td.train_x.shape[1] == 20 and td.provenance == "real:cache"
    np.testing.assert_array_equal(td.train_x[0, 1:], td.train_y[0, :-1])
    first = "".join(ALL_LETTERS[int(t) - 1] for t in td.train_x[0][:8])
    assert first == CORPUS[:8]
    for a, b in zip(j_leaf.load_shakespeare_raw(str(path), 16, stride=7),
                    t_leaf.load_shakespeare_raw(str(path), 16, stride=7)):
        assert b.flags.c_contiguous and b.flags.writeable
        np.testing.assert_array_equal(a, b)


def test_shakespeare_leaf_layout_and_npz(tmp_path):
    """A LEAF layout keeps its natural per-user partition (and wins over
    the raw corpus beside it); an ``<name>.npz`` is read as it stands."""
    root = tmp_path / "shakespeare"
    users = ["u0", "u1", "u2"]
    rows = {"u0": ["To be, or not", "that is"], "u1": ["the question"],
            "u2": ["Whether 'tis", "nobler in", "the mind"]}
    for split in ("train", "test"):
        (root / split).mkdir(parents=True)
        data = {u: {"x": rows[u], "y": [r[1:] + " " for r in rows[u]]}
                for u in users}
        blob = {"users": users if split == "train" else users[1:],
                "num_samples": [len(rows[u]) for u in users],
                "user_data": data}
        (root / split / "all.json").write_text(json.dumps(blob))
    (tmp_path / "shakespeare.txt").write_text(CORPUS)
    td = _same_lm_dataset(dict(dataset="shakespeare",
                               data_cache_dir=str(tmp_path), seq_len=9))
    assert td.provenance == "real:leaf" and td.num_clients == 3
    assert [len(td.client_idxs[c]) for c in range(3)] == [2, 1, 3]

    rng = np.random.default_rng(1)
    npz = tmp_path / "npz"
    npz.mkdir()
    np.savez(npz / "stackoverflow_nwp.npz",
             train_x=rng.integers(0, 10004, (12, 20)),
             train_y=rng.integers(0, 10004, (12, 20)),
             test_x=rng.integers(0, 10004, (3, 20)),
             test_y=rng.integers(0, 10004, (3, 20)))
    td = _same_lm_dataset(dict(dataset="stackoverflow_nwp",
                               data_cache_dir=str(npz)))
    assert td.provenance == "real:cache" and td.train_x.shape == (12, 20)


@pytest.mark.parametrize("over", [
    dict(dataset="shakespeare", train_size=50, test_size=10, seq_len=12),
    dict(dataset="stackoverflow_nwp", train_size=40, test_size=8,
         data_cache_dir="/nonexistent-cache")])
def test_lm_synthetic_fallback_bitwise(over):
    td = _same_lm_dataset(over)
    assert td.provenance == "synthetic"


def test_hub_names_build_the_reference_models():
    """``rnn``/``rnn_fedavg``/``rnn_shakespeare`` default to seq 80 and
    vocab 90, ``rnn_stackoverflow``/``rnn_nwp`` to seq 20 and vocab 10004
    (``output_dim`` 0), as the JAX hub builds them."""
    for name, seq, vocab in (("rnn_fedavg", 80, 90),
                             ("rnn_shakespeare", 80, 90),
                             ("rnn_nwp", 20, 10004)):
        args = types.SimpleNamespace(model=name, dataset="x")
        tm, jm = t_model.create(args, 0), j_model.create(args, 0)
        assert tuple(tm.input_shape) == tuple(jm.input_shape) == (seq,)
        p = {k: v.shape for k, v in from_flax(jax.device_get(jm.init(
            jax.random.PRNGKey(0))), tm, device="cpu").items()}
        assert p["Embed_0.weight"][0] == vocab
