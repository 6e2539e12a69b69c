"""The FedNLP text transformer and its data path against the JAX package's,
on the CPU, and the flash-attention kernel Functions under ``torch.func``.

- Kernel Functions: on the CPU they run the kernels' plain versions through
  the same ``setup_context``, ``vmap`` rules and backward wiring the card
  uses.  ``vmap(grad_and_value)`` over a cohort, nested maps, broadcast
  (unmapped) arguments and non-contiguous inputs all equal a per-client
  loop of ``torch.autograd.grad`` to 1e-6 in f32 (in practice bitwise:
  each kernel's plain version treats the batch rows independently), and
  each map is one call of each kernel on the folded batch.
- Model: the flax module (attention through ``blockwise_attention`` off
  the TPU) and the port's at the same weights (``models/convert.py``) on
  one ragged-pad batch: logits, loss and every gradient within 1e-5
  (absolute, and relative to the largest entry), at
  ``tests/test_model_zoo_ext.py``'s size (seq 32, vocab 512, dim 64, 2
  layers, 4 heads, FFN 128).
- Data: ``synthetic_text_classification`` and the ``realtext`` shard
  bitwise the JAX loader's arrays, provenance included.
- Rounds: two FedAvg rounds against the JAX ``FedAvgAPI`` from the same
  weights: SGD params within 1e-5; Adam with clip at lr 1e-3 within 1e-4
  (Adam's normalised step turns f32 summation-order noise into
  differences proportional to lr: measured 6.7e-5 here, SGD 1.2e-7).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import data as j_data
from fedml_tpu import model as j_model
from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.data import synthetic as j_synthetic
from fedml_tpu.ml.trainer.local_trainer import cross_entropy_loss as j_xent
from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI

import fedml_tpu_torch
from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.core import rng as t_rng
from fedml_tpu_torch.data import synthetic as t_synthetic
from fedml_tpu_torch.ml.trainer.local_trainer import \
    cross_entropy_loss as t_xent
from fedml_tpu_torch.models.base import param_kinds
from fedml_tpu_torch.models.convert import from_flax, to_flax
from fedml_tpu_torch.ops import attention as tatt
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvgAPI

REALTEXT = str(pathlib.Path(__file__).resolve().parents[1] / "data_shards"
               / "realtext")
FUNC_TOL = 1e-6
TOL = 1e-5
ADAM_TOL = 1e-4

#: tests/test_model_zoo_ext.py::test_text_transformer_fednlp_learns' config
SMALL = dict(dataset="20news", model="distilbert", seq_len=32,
             vocab_size=512, model_dim=64, model_layers=2, model_heads=4,
             model_ffn_dim=128, text_class_signal=0.5, text_keyword_width=1.0,
             train_size=600, test_size=120, client_num_in_total=6,
             client_num_per_round=3, epochs=1, batch_size=20,
             learning_rate=0.1, partition_method="homo",
             frequency_of_the_test=10 ** 9, random_seed=0)



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread is as fast alone and avoids the
    thread oversubscription that stalls these tests when several test
    processes share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

# -- the kernel Functions under torch.func -----------------------------------

class _Spy:
    """Records the q shape of every call of the three kernel wrappers."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            monkeypatch.setattr(tatt, name, self._wrap(name,
                                                       getattr(tatt, name)))

    def _wrap(self, name, fn):
        def spy(*args, **kw):
            self.calls.append((name, tuple(args[0].shape)))
            return fn(*args, **kw)
        return spy


def _cohort(c, b, h, s, d, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    mk = lambda: torch.tensor(rng.standard_normal(
        lead + (c, b, h, s, d)).astype(np.float32))
    return mk(), mk(), mk(), mk()


def _loss(q, k, v, w, causal=False):
    return (tatt.flash_attention(q, k, v, causal) * w).sum()


def _loop_grads(q, k, v, w, causal=False):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    loss = _loss(*leaves, w, causal)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _close(got, want, tol=FUNC_TOL):
    assert (got - want).abs().max() <= tol


@pytest.mark.parametrize("d,causal", [(32, False), (16, False), (32, True)])
def test_vmap_grad_and_value_matches_per_client_loop(monkeypatch, d, causal):
    """``vmap(grad_and_value)`` over a cohort of 4 clients: one call of
    each kernel on the folded (C·B, H, S, D) batch, and loss and dQ/dK/dV
    equal to a per-client loop of ``torch.autograd.grad``."""
    c, b, h, s = 4, 2, 4, 40
    q, k, v, w = _cohort(c, b, h, s, d)
    spy = _Spy(monkeypatch)
    grads, loss = torch.func.vmap(torch.func.grad_and_value(
        lambda *a: _loss(*a, causal), argnums=(0, 1, 2)))(q, k, v, w)
    assert spy.calls == [(n, (c * b, h, s, d)) for n in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")]
    for i in range(c):
        li, gi = _loop_grads(q[i], k[i], v[i], w[i], causal)
        _close(loss[i], li)
        for got, want in zip(grads, gi):
            _close(got[i], want)


def test_nested_vmap_folds_members_and_clients_once(monkeypatch):
    """A member map around the cohort map (a population): each level's
    rule folds once more, so the whole (P·C·B) batch is one call of each
    kernel, and every (member, client) equals its own loop."""
    p, c, b, h, s, d = 2, 3, 2, 2, 24, 16
    q, k, v, w = _cohort(c, b, h, s, d, seed=1, lead=(p,))
    spy = _Spy(monkeypatch)
    f = torch.func.grad_and_value(_loss, argnums=(0, 1, 2))
    grads, loss = torch.func.vmap(torch.func.vmap(f))(q, k, v, w)
    assert [shape for _, shape in spy.calls] == [(p * c * b, h, s, d)] * 3
    for m in range(p):
        for i in range(c):
            li, gi = _loop_grads(q[m, i], k[m, i], v[m, i], w[m, i])
            _close(loss[m, i], li)
            for got, want in zip(grads, gi):
                _close(got[m, i], want)


def test_vmap_broadcasts_an_unmapped_argument(monkeypatch):
    """K and V shared by the cohort (``in_dims`` None) are expanded into
    the fold: one call, and the same numbers as the loop."""
    c, b, h, s, d = 3, 2, 2, 32, 32
    q, k, v, w = _cohort(c, b, h, s, d, seed=2)
    k0, v0 = k[0], v[0]
    spy = _Spy(monkeypatch)
    grads, loss = torch.func.vmap(
        torch.func.grad_and_value(_loss, argnums=(0, 1, 2)),
        in_dims=(0, None, None, 0))(q, k0, v0, w)
    assert len(spy.calls) == 3
    for i in range(c):
        li, (gq, gk, gv) = _loop_grads(q[i], k0, v0, w[i])
        _close(loss[i], li)
        _close(grads[0][i], gq)
        _close(grads[1][i], gk)
        _close(grads[2][i], gv)


def test_vmap_takes_non_contiguous_inputs():
    """A mapped dim that is not the leading one, and head/sequence axes
    transposed as the model's reshapes leave them: the rule moves and
    folds them, copying only what cannot be viewed."""
    c, b, h, s, d = 3, 2, 2, 20, 16
    q, k, v, w = _cohort(c, b, h, s, d, seed=3)
    # client axis second, and (S, H) swapped in memory
    qt = q.transpose(2, 3).contiguous().transpose(2, 3).movedim(0, 1)
    assert not qt.is_contiguous()
    grads, loss = torch.func.vmap(
        torch.func.grad_and_value(_loss, argnums=(0, 1, 2)),
        in_dims=(1, 0, 0, 0))(qt, k, v, w)
    for i in range(c):
        li, gi = _loop_grads(q[i], k[i], v[i], w[i])
        _close(loss[i], li)
        for got, want in zip(grads, gi):
            _close(got[i], want)


def test_plain_autograd_and_grad_agree_and_double_backward_raises():
    q, k, v, w = (t[0] for t in _cohort(1, 2, 2, 24, 16, seed=4))
    g = torch.func.grad(_loss, argnums=(0, 1, 2))(q, k, v, w)
    _, ref = _loop_grads(q, k, v, w)
    assert all(torch.equal(a, b) for a, b in zip(g, ref))
    inner = lambda x: torch.func.grad(_loss)(x, k, v, w).sum()
    with pytest.raises(RuntimeError, match="double backward"):
        torch.func.grad(inner)(q)


# -- the model against flax --------------------------------------------------

def _models(**over):
    cfg = dict(SMALL, **over)
    jm = j_model.create(j_arguments().update(**cfg), 20)
    tm = t_model.create(t_arguments().update(**cfg), 20)
    return jm, tm


def _tokens(seed=0, batch=6, seq=32, vocab=512):
    """Token ids with a ragged pad tail per row (one row all padding)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, vocab, (batch, seq)).astype(np.int32)
    for i, n in enumerate([32, 24, 17, 5, 1, 0][:batch]):
        x[i, n:] = 0
    return x, rng.integers(0, 20, batch)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _allclose(got, want, what, tol=TOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def test_text_transformer_matches_flax():
    """Logits, loss and every gradient against the flax module from the
    same weights, on one ragged-pad batch."""
    jm, tm = _models()
    assert tm.input_dtype == torch.int32 and tm.input_shape == (32,)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    tp = from_flax(jp, tm, device="cpu")
    x, y = _tokens()

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(x))
        return j_xent(logits, jnp.asarray(y)), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)

    def tloss(p):
        logits = tm.apply(p, torch.tensor(x))
        return t_xent(logits, torch.tensor(y)), logits

    tg, (tl, tlogits) = torch.func.grad_and_value(tloss, has_aux=True)(tp)
    _allclose(tlogits, jlogits, "logits")
    _allclose(tl, jl, "loss")
    ref = from_flax(jax.device_get(jg), tm, device="cpu")
    assert set(tg) == set(ref)
    for k in tp:
        _allclose(tg[k], ref[k], f"grad {k}")


def test_padding_invariance():
    """As the JAX test pins: zeroing a position that is already padding
    leaves the logits unchanged."""
    _, tm = _models()
    tp = tm.init(t_rng.purpose_key(t_rng.root_key(0), "init"))
    x, _ = _tokens(seed=1)
    toks = torch.tensor(x)
    toks[:, 24:] = 0
    a = tm.apply(tp, toks)
    b = tm.apply(tp, toks.clone().index_fill_(1, torch.tensor([30]), 0))
    assert torch.equal(a, b)
    assert torch.isfinite(a).all()


def test_from_flax_round_trip_carries_nested_names():
    jm, tm = _models()
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    kinds = param_kinds(tm.module)
    assert kinds["pos_embed"][:2] == ("param", "pos_embed")
    assert kinds["tok_embed.weight"][:2] == ("embedding",
                                             "tok_embed/embedding")
    assert kinds["layer_1.LayerNorm_0.weight"][:2] == (
        "scale", "layer_1/LayerNorm_0/scale")
    assert kinds["layer_0.wq.weight"][:2] == ("dense", "layer_0/wq/kernel")
    back = to_flax(from_flax(jp, tm, device="cpu"), tm)
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(leaves) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in leaves:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)
    bad = dict(jp)
    bad.pop("pos_embed")
    with pytest.raises(ValueError, match="pos_embed"):
        from_flax(bad, tm, device="cpu")


def test_init_follows_flax_initialisers():
    """Per initialiser, at the model's full default width: the Embed
    table a plain normal of std 1/sqrt(256) = 0.0625 (untruncated), the
    position table normal(0.02), LayerNorm scales 1 and biases 0, Dense
    kernels ``lecun_normal`` cut at 2 std, biases 0; the same shapes and
    spreads as flax's own init."""
    cfg = dict(model="text_transformer", seq_len=128, vocab_size=8192)
    jm = j_model.create(j_arguments().update(**cfg), 10)
    tm = t_model.create(t_arguments().update(**cfg), 10)
    tp = tm.init(t_rng.purpose_key(t_rng.root_key(0), "init"))
    ref = from_flax(jax.device_get(jm.init(jax.random.PRNGKey(0))), tm,
                    device="cpu")
    assert tp.keys() == ref.keys()
    emb = tp["tok_embed.weight"]
    assert abs(float(emb.std()) - 0.0625) < 0.0625 * 0.01
    assert float(emb.abs().max()) > 4 * 0.0625          # not truncated
    assert abs(float(tp["pos_embed"].std()) - 0.02) < 0.02 * 0.02
    for name, (kind, _, _) in param_kinds(tm.module).items():
        v = tp[name]
        assert v.shape == ref[name].shape and v.dtype == torch.float32
        if kind == "scale":
            assert torch.equal(v, torch.ones_like(v)), name
        elif kind == "bias":
            assert torch.count_nonzero(v) == 0, name
        elif kind == "dense":
            std = v.shape[1] ** -0.5
            assert float(v.abs().max()) <= 2 * std / 0.8796256610342398 \
                + 1e-6, name
            assert abs(float(v.std()) / std - 1) < 0.05, name
        if v.numel() >= 5000 and kind != "scale":
            want = float(ref[name].std())
            assert abs(float(v.std()) - want) < 0.05 * want, name


# -- data --------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (100, 30, 20, 30000, 128, 3, 0.25, 2.5),
    (64, 16, 4, 2000, 64, 0, 0.35, 2.0),
    (50, 10, 10, 512, 32, 7, 0.5, 1.0)])
def test_synthetic_text_matches_jax_bitwise(args):
    train_n, test_n, classes, vocab, seq, seed, sig, kw = args
    got = t_synthetic.synthetic_text_classification(
        train_n, test_n, classes, vocab, seq, seed, class_signal=sig,
        keyword_width=kw)
    want = j_synthetic.synthetic_text_classification(
        train_n, test_n, classes, vocab, seq, seed, class_signal=sig,
        keyword_width=kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _load_both(**over):
    cfg = dict(client_num_in_total=10, partition_method="hetero",
               partition_alpha=0.5, random_seed=0)
    cfg.update(over)
    jds, jn = j_data.load(j_arguments().update(**cfg))
    tds, tn = t_data.load(t_arguments().update(**cfg))
    assert tn == jn
    for f in ("train_x", "train_y", "test_x", "test_y"):
        a, b = getattr(tds, f), getattr(jds, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    assert tds.client_idxs.keys() == jds.client_idxs.keys()
    for c in jds.client_idxs:
        np.testing.assert_array_equal(tds.client_idxs[c], jds.client_idxs[c])
    assert tds.provenance == jds.provenance
    return tds, tn


@pytest.mark.parametrize("over", [
    dict(dataset="realtext", data_cache_dir=REALTEXT, seq_len=128,
         vocab_size=8192),
    dict(dataset="20news", seq_len=64, vocab_size=2000, train_size=400,
         test_size=80),
    dict(dataset="agnews", train_size=300, test_size=60),
    dict(dataset="fednlp", seq_len=16, vocab_size=300, train_size=200,
         test_size=40, text_class_signal=0.5, text_keyword_width=1.0)])
def test_text_loaders_match_jax_bitwise(over):
    ds, n = _load_both(**over)
    if over["dataset"] == "realtext":
        assert ds.provenance.startswith("real:installed-package-docs")
        assert n == 10 and ds.train_x.shape == (2967, 128)
    else:
        assert ds.provenance == "synthetic"


# -- FedAvg rounds against the JAX engine ------------------------------------

def _pair(cfg):
    jargs = j_arguments().update(**cfg)
    jds, jn = j_data.load(jargs)
    japi = JFedAvgAPI(jargs, None, jds, j_model.create(jargs, jn))
    targs = t_arguments().update(**cfg)
    tds, tn = t_data.load(targs)
    tm = t_model.create(targs, tn)
    tapi = TFedAvgAPI(targs, "cpu", tds, tm)
    tapi.state = tapi.state.replace(global_params=from_flax(
        jax.device_get(japi.state.global_params), tm, device="cpu"))
    return japi, tapi


@pytest.mark.parametrize("over,tol", [
    (dict(), TOL),
    (dict(client_optimizer="adam", learning_rate=1e-3, clip_grad_norm=1.0),
     ADAM_TOL)])
def test_fedavg_rounds_match_jax(over, tol):
    japi, tapi = _pair(dict(SMALL, comm_round=2, **over))
    for r in range(2):
        jm, tm = japi.train_one_round(r), tapi.train_one_round(r)
        assert float(tm["total_steps"]) == float(jm["total_steps"])
        assert abs(float(tm["train_loss"]) - float(jm["train_loss"])) < tol
    ref = from_flax(jax.device_get(japi.state.global_params), tapi.model,
                    device="cpu")
    err = max(float((v - ref[k]).abs().max())
              for k, v in tapi.state.global_params.items())
    assert err <= tol, err
    (jl, ja), (tl, ta) = japi.evaluate(), tapi.evaluate()
    assert abs(tl - jl) < tol and abs(ta - ja) < 1e-6


@pytest.mark.parametrize("dataset,over", [
    ("realtext", dict(data_cache_dir=REALTEXT, seq_len=128,
                      vocab_size=8192)),
    ("20news", dict(seq_len=32, vocab_size=512, train_size=160,
                    test_size=40)),
    ("agnews", dict(seq_len=16, vocab_size=256, train_size=160,
                    test_size=40)),
    ("fednlp", dict(seq_len=16, vocab_size=256, train_size=160,
                    test_size=40))])
def test_run_simulation_trains_the_text_model(dataset, over):
    """``run_simulation(backend="sp")`` on every text dataset and model
    alias, on the CPU when asked: finite params that moved."""
    name, classes = {"realtext": ("text_transformer", 10),
                     "20news": ("distilbert", 20), "agnews": ("bert", 4),
                     "fednlp": ("transformer_cls", 20)}[dataset]
    args = t_arguments().update(
        dataset=dataset, model=name, model_dim=32, model_layers=1,
        model_heads=2, model_ffn_dim=64, client_num_in_total=4,
        client_num_per_round=2, comm_round=1, batch_size=16,
        learning_rate=3e-3, client_optimizer="adam", clip_grad_norm=1.0,
        frequency_of_the_test=1, random_seed=0, **over)
    start = t_model.create(args, classes).init(
        t_rng.purpose_key(t_rng.root_key(0), "init"))
    params = fedml_tpu_torch.run_simulation(backend="sp", args=args,
                                            device="cpu")
    for k, v in params.items():
        assert torch.isfinite(v).all(), k
    assert all(not torch.equal(v, start[k]) for k, v in params.items())
