"""The sp path's models and client optimizer against the JAX package's.

Models: the flax module and the port's, at the same weights (carried by
``models/convert.py``), on the same numpy inputs: logits, the mean
cross-entropy and its gradient with respect to every parameter agree in
f32 to 1e-5 (absolute, and relative to the largest entry of the tensor
compared).  ``CNNDropOut`` in train mode is run with the dropout masks
flax drew, captured with ``flax.linen.intercept_methods``.

Optimizer: the port's functional SGD/Adam against the optax chain
``fedml_tpu.core.state.make_client_optimizer`` builds, step by step, to
1e-6.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.core import federated as j_federated
from fedml_tpu.core import tree as j_tree
from fedml_tpu.core.state import make_client_optimizer as j_optimizer
from fedml_tpu.ml.trainer.local_trainer import accuracy as j_accuracy
from fedml_tpu.ml.trainer.local_trainer import cross_entropy_loss as j_xent
from fedml_tpu.models import model_hub as j_hub
from fedml_tpu_torch import data as t_data
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.core import rng as t_rng
from fedml_tpu_torch.core import tree as t_tree
from fedml_tpu_torch.core.state import make_client_optimizer as t_optimizer
from fedml_tpu_torch.ml.trainer.local_trainer import accuracy as t_accuracy
from fedml_tpu_torch.ml.trainer.local_trainer import \
    cross_entropy_loss as t_xent
from fedml_tpu_torch.models import model_hub as t_hub
from fedml_tpu_torch.models.convert import from_flax, to_flax

TOL = 1e-5

CASES = [
    # model, dataset, input_shape, classes
    ("lr", "synthetic", (28, 28, 1), 10),
    ("mlp", "synthetic", (12,), 4),
    ("cnn_web", "synthetic", (28, 28, 1), 10),
    ("cnn_cifar", "cifar10", (32, 32, 3), 10),
    ("cnn", "femnist", (28, 28, 1), 62),
    ("cnn", "digits", (8, 8, 1), 10),
]


def _models(name, ds, shape, classes):
    over = dict(model=name, dataset=ds, input_shape=shape)
    jm = j_hub.create(j_arguments().update(**over), classes)
    tm = t_hub.create(t_arguments().update(**over), classes)
    return jm, tm


def _close(got, want, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


def _inputs(shape, classes, seed=0, batch=6):
    rng = np.random.default_rng(seed)
    x = rng.random((batch,) + tuple(shape), np.float32)
    y = rng.integers(0, classes, batch)
    return x, y


def _capture_dropout(jm, params, x, key):
    """Train-mode flax forward; returns the keep-mask of each Dropout call
    (an entry whose input is 0 is 0 either way and reads as kept)."""
    masks = []

    def grab(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dropout) and \
                context.method_name == "__call__":
            masks.append(np.asarray((out != 0) | (args[0] == 0)))
        return out

    with nn.intercept_methods(grab):
        jm.apply(params, jnp.asarray(x), train=True, rng=key)
    return masks


@pytest.mark.parametrize("name,ds,shape,classes", CASES)
def test_forward_and_gradients_match_flax(name, ds, shape, classes):
    jm, tm = _models(name, ds, shape, classes)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    tp = from_flax(jp, tm, device="cpu")
    x, y = _inputs(shape, classes)
    train = tm.has_dropout
    key = jax.random.PRNGKey(9)
    masks = None
    if train:
        masks = _capture_dropout(jm, jp, x, key)
        assert len(masks) == 2 and all(m.mean() < 1 for m in masks)

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(x), train=train, rng=key)
        return j_xent(logits, jnp.asarray(y)), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tmasks = None if masks is None else tuple(torch.tensor(m) for m in masks)

    def tloss(p):
        logits = tm.apply(p, torch.tensor(x), train=train,
                          dropout_masks=tmasks)
        return t_xent(logits, torch.tensor(y)), logits

    (tg, (tl, tlogits)) = torch.func.grad_and_value(tloss, has_aux=True)(tp)
    _close(tlogits, jlogits, "logits")
    _close(tl, jl, "loss")
    ref = from_flax(jax.device_get(jg), tm, device="cpu")
    for k in tp:
        _close(tg[k], ref[k].numpy(), f"grad {k}")
    if train:
        # eval mode ignores masks: deterministic, and equal to flax's
        _close(tm.apply(tp, torch.tensor(x), train=False),
               jm.apply(jp, jnp.asarray(x), train=False), "eval logits")


@pytest.mark.parametrize("name,ds,shape,classes", CASES)
def test_convert_round_trip_and_init(name, ds, shape, classes):
    jm, tm = _models(name, ds, shape, classes)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    back = to_flax(from_flax(jp, tm, device="cpu"), tm)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)
    # the port's own init: flax's shapes and its default distribution
    # (lecun_normal kernels cut at ±2 std, zero biases)
    tp = tm.init(t_rng.purpose_key(t_rng.root_key(0), "init"))
    ref = from_flax(jp, tm, device="cpu")
    assert tp.keys() == ref.keys()
    for k, v in tp.items():
        assert v.shape == ref[k].shape and v.dtype == torch.float32
        if k.endswith("bias"):
            assert torch.count_nonzero(v) == 0
            continue
        fan_in = int(np.prod(v.shape[1:]))
        std = (1.0 / fan_in) ** 0.5
        assert float(v.abs().max()) <= 2 * std / 0.8796256610342398 + 1e-6
        if v.numel() >= 5000:
            assert abs(float(v.std()) / std - 1) < 0.05, k
            assert abs(float(v.std()) - float(ref[k].std())) < 0.05 * std


def test_from_flax_refuses_mismatched_trees():
    jm, tm = _models("cnn_web", "synthetic", (28, 28, 1), 10)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    bad = dict(jp, Extra_0={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="Extra_0"):
        from_flax(bad, tm, device="cpu")
    _, small = _models("cnn_web", "synthetic", (12, 12, 1), 10)
    with pytest.raises(ValueError, match="Dense_0/kernel"):
        from_flax(jp, small, device="cpu")


def test_dropout_masks_follow_the_generator():
    _, tm = _models("cnn", "femnist", (28, 28, 1), 62)
    g = lambda: t_rng.round_key(t_rng.root_key(4), 2)
    a = tm.dropout_masks(g(), (3, 2, 5))
    b = tm.dropout_masks(g(), (3, 2, 5))
    assert [m.shape for m in a] == [(3, 2, 5, 3136), (3, 2, 5, 128)]
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert abs(float(a[0].float().mean()) - 0.75) < 0.02
    assert abs(float(a[1].float().mean()) - 0.5) < 0.05
    c = tm.dropout_masks(t_rng.round_key(t_rng.root_key(4), 3), (3, 2, 5))
    assert not torch.equal(a[0], c[0])


def test_unported_models_raise_by_name():
    for name in ("resnet34", "gan", "vit"):
        with pytest.raises(NotImplementedError, match=name):
            t_hub.create(t_arguments().update(model=name), 10)
    with pytest.raises(NotImplementedError, match="large image"):
        t_data.load(t_arguments().update(model="lr", dataset="imagenet"))


@pytest.mark.parametrize("over", [
    dict(), dict(weight_decay=0.0), dict(momentum=0.9),
    dict(momentum=0.5, clip_grad_norm=0.05),
    dict(client_optimizer="adam", weight_decay=0.0),
    dict(client_optimizer="adam", weight_decay=0.01, clip_grad_norm=0.1)])
def test_client_optimizer_matches_optax(over):
    """Five steps of the port's optimizer against optax's chain, on the
    same params and gradients."""
    cfg = dict(learning_rate=0.1, **over)
    jtx = j_optimizer(j_arguments().update(**cfg))
    ttx = t_optimizer(t_arguments().update(**cfg))
    rng = np.random.default_rng(1)
    p = {"Dense_0.weight": rng.standard_normal((5, 7)).astype(np.float32),
         "Dense_0.bias": rng.standard_normal(5).astype(np.float32)}
    jp = dict(p)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p.items()}
        ju, js = jtx.update(g, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.tensor(v) for k, v in g.items()}, ts,
                            tp)
        tp = {k: v + tu[k] for k, v in tp.items()}
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("over", [
    dict(momentum=0.9), dict(client_optimizer="adam", weight_decay=0.01)])
def test_padded_step_is_a_true_no_op(over):
    """A step with mask 0 keeps params AND optimizer state bitwise (weight
    decay, momentum and Adam's count included); mask 1 moves both."""
    from fedml_tpu_torch.ml.trainer.local_trainer import LocalTrainer

    args = t_arguments().update(model="lr", dataset="synthetic",
                                input_shape=(12,), learning_rate=0.1, **over)
    model = t_hub.create(args, 4)
    trainer = LocalTrainer(model, args)
    params = model.init(t_rng.root_key(0))
    state = trainer.tx.init(params)
    x, y = (torch.tensor(a) for a in _inputs((12,), 4))
    zero = torch.zeros(())
    p1, s1, _, _, _, _ = trainer.train_step(
        (params, state, None, None, zero, zero), x, y, torch.ones(()))
    p2, s2, _, _, n2, l2 = trainer.train_step(
        (p1, s1, None, None, zero, zero), x, y, torch.zeros(()))
    assert all(torch.equal(p2[k], p1[k]) for k in p1)
    assert all(torch.equal(s2[k], s1[k]) for k in s1)
    assert float(n2) == 0 and float(l2) == 0
    assert not torch.equal(p1["Dense_0.weight"], params["Dense_0.weight"])
    assert not all(torch.equal(s1[k], state[k]) for k in state)


def test_metrics_and_reductions_match_jax():
    """``cross_entropy_loss``, ``accuracy`` and the port's one weighted
    average, ``stacked_weighted_average``, against the JAX package's
    ``weighted_reduce`` and ``stacked_weighted_average`` on the same inputs
    (1e-6), with a zero-weight (padded) client."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((7, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 7)
    _close(t_xent(torch.tensor(logits), torch.tensor(labels)),
           j_xent(jnp.asarray(logits), jnp.asarray(labels)), "xent")
    assert float(t_accuracy(torch.tensor(logits), torch.tensor(labels))) \
        == float(j_accuracy(jnp.asarray(logits), jnp.asarray(labels)))
    stacked = {"a": rng.standard_normal((4, 3, 2)).astype(np.float32),
               "b": rng.standard_normal((4, 6)).astype(np.float32)}
    w = np.array([3.0, 0.0, 7.0, 1.5], np.float32)
    tstacked = {k: torch.tensor(v) for k, v in stacked.items()}
    got = t_tree.stacked_weighted_average(tstacked, torch.tensor(w))
    for jfn in (j_federated.weighted_reduce, j_tree.stacked_weighted_average):
        want = jfn({k: jnp.asarray(v) for k, v in stacked.items()},
                   jnp.asarray(w))
        for k in stacked:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-6, err_msg=k)
