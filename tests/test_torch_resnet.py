"""The GroupNorm ResNets against the JAX package's, on the CPU, and the
model hub over every ported name.

- Models: the flax module and the port's at the same weights
  (``models/convert.py``) on the same numpy images: logits, the mean
  cross-entropy and its gradient with respect to every parameter within
  1e-5 (absolute, and relative to the largest entry of the tensor), for
  ``resnet20`` and ``resnet18_gn_w8`` on 2 images of 32×32×3 and
  ``resnet18_gn`` at full width.  At full width the reference is flax run
  in float64: flax's own f32 gradients of the first stage lie 3.4e-3
  (relative) from its f64 ones there, the port's f32 2.8e-6.
- flax's ``SAME`` padding at stride 2 is pinned against ``flax.linen.Conv``
  itself.
- Rounds: two FedProx (μ 0.1) rounds of ``resnet18_gn_w8`` against the JAX
  ``FedAvgAPI`` from the same weights, on the synthetic CIFAR-100 stand-in,
  params and round losses within 1e-3.  These rounds are ill-conditioned
  in f32: on their first batch the first stage's gradients of both
  packages lie up to 4.7e-4 (of entries up to 0.18) from the f64
  gradient, which both packages agree on to 1e-8, so the two f32 runs
  read 1.7e-5 apart after one step at lr 0.05 and 2.7e-4 after two.
"""

import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import data as j_data
from fedml_tpu import model as j_model
from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.ml.trainer.local_trainer import cross_entropy_loss as j_xent
from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI

import fedml_tpu_torch
from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.core import rng as t_rng
from fedml_tpu_torch.ml.trainer.local_trainer import \
    cross_entropy_loss as t_xent
from fedml_tpu_torch.models import model_hub as t_hub
from fedml_tpu_torch.models.convert import from_flax, to_flax
from fedml_tpu_torch.models.resnet import ConvSame, same_pads
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvgAPI

TOL = 1e-5
#: two f32 ResNet rounds on the CIFAR stand-in (see the module docstring)
ROUND_TOL = 1e-3



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread is as fast alone and avoids the
    thread oversubscription that stalls these tests when several test
    processes share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

def _close(got, want, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("name,classes,f64", [("resnet20", 10, False),
                                              ("resnet18_gn_w8", 100, False),
                                              ("resnet18_gn", 100, True)])
def test_forward_and_gradients_match_flax(name, classes, f64):
    cfg = dict(model=name, dataset="cifar100")
    jm = j_model.create(j_arguments().update(**cfg), classes)
    tm = t_model.create(t_arguments().update(**cfg), classes)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(1)))
    tp = from_flax(jp, tm, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.random((2, 32, 32, 3), np.float32)
    y = rng.integers(0, classes, 2)

    def jloss(p, xj):
        logits = jm.apply(p, xj)
        return j_xent(logits, jnp.asarray(y)), logits

    grad_fn = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    if f64:
        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), jp)
            (jl, jlogits), jg = jax.device_get(
                grad_fn(p64, jnp.asarray(x, jnp.float64)))
    else:
        (jl, jlogits), jg = grad_fn(jp, jnp.asarray(x))

    def tloss(p):
        logits = tm.apply(p, torch.tensor(x))
        return t_xent(logits, torch.tensor(y)), logits

    tg, (tl, tlogits) = torch.func.grad_and_value(tloss, has_aux=True)(tp)
    _close(tlogits, jlogits, "logits")
    _close(tl, jl, "loss")
    ref = from_flax(jax.device_get(jg), tm, device="cpu")
    assert set(tg) == set(ref)
    for k in tp:
        _close(tg[k], ref[k].numpy(), f"grad {k}")
    # the round trip back to flax's tree
    back = to_flax(tp, tm)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


@pytest.mark.parametrize("size,k,stride", [(32, 3, 2), (16, 3, 2), (7, 3, 2),
                                           (32, 3, 1), (32, 1, 2), (9, 1, 2)])
def test_stride2_same_padding_is_flax_s(size, k, stride):
    """flax ``padding="SAME"`` is XLA's rule: a 3×3 stride-2 convolution on
    an even size pads (0, 1), not (1, 1); a 1×1 stride-2 one pads
    nothing.  The port's ``ConvSame`` gives flax's output on the same
    weights."""
    lo, hi = same_pads(size, k, stride)
    if (size, k, stride) == (32, 3, 2):
        assert (lo, hi) == (0, 1)
    if k == 1:
        assert (lo, hi) == (0, 0)
    rng = np.random.default_rng(size + k + stride)
    x = rng.standard_normal((1, size, size, 4)).astype(np.float32)
    conv = fnn.Conv(5, (k, k), strides=(stride, stride), padding="SAME",
                    use_bias=False)
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    tc = ConvSame(4, 5, k, stride)
    with torch.no_grad():
        tc.weight.copy_(torch.tensor(np.asarray(
            params["params"]["kernel"]).transpose(3, 2, 0, 1)))
    got = tc(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


#: every name the port's hub creates, with the extra args
#: tests/test_model_zoo_ext.py::test_model_hub_every_name_creates_and_forwards
#: gives it
HUB_CASES = [
    ("lr", 4, dict(input_shape=(16, 16, 3))),
    ("logistic_regression", 4, dict(input_shape=(16, 16, 3))),
    ("mlp", 4, dict(input_shape=(16, 16, 3))),
    ("cnn", 62, {}), ("cnn_web", 4, dict(input_shape=(16, 16, 3))),
    ("cnn_cifar", 10, {}), ("resnet18", 10, {}), ("resnet18_gn", 10, {}),
    ("resnet18_gn_w16", 10, {}), ("resnet56", 10, {}), ("resnet20", 10, {}),
    ("resnet20_mnn", 10, {}),
    ("text_transformer", 4, dict(seq_len=12, vocab_size=64)),
    ("distilbert", 4, dict(seq_len=12, vocab_size=64)),
    ("bert", 4, dict(seq_len=12, vocab_size=64)),
    ("transformer_cls", 4, dict(seq_len=12, vocab_size=64)),
    ("rnn", 90, {}), ("rnn_fedavg", 0, {}), ("rnn_shakespeare", 90,
                                              dict(seq_len=12)),
    ("rnn_stackoverflow", 64, dict(seq_len=8)), ("rnn_nwp", 64, {}),
    ("lr", 12, dict(dataset="stackoverflow_lr", input_shape=(40,))),
    ("vgg", 10, dict(input_shape=(32, 32, 3))),
    ("vgg11", 10, dict(input_shape=(32, 32, 3))),
    ("vgg13", 4, dict(input_shape=(16, 16, 3))),
    ("vgg16", 4, dict(input_shape=(16, 16, 1))),
    ("vgg19", 10, dict(input_shape=(8, 8, 1))),
    ("mobilenet", 10, {}), ("mobilenet_v3", 100, {}),
    ("efficientnet", 10, {}),
    ("gcn", 3, dict(max_nodes=12, node_feature_dim=8)),
    ("graph", 2, {}), ("fedgraphnn", 4, dict(model_dim=16)),
]


@pytest.mark.parametrize("name,out_dim,extra", HUB_CASES)
def test_model_hub_every_name_creates_and_forwards(name, out_dim, extra):
    """Every ported name creates, inits and forwards a batch of 2 of its
    input dtype, with the JAX hub's input shape, input dtype and output
    shape."""
    args = types.SimpleNamespace(**dict(dict(model=name, dataset="x"),
                                        **extra))
    m = t_hub.create(args, out_dim)
    jm = j_model.create(args, out_dim)
    assert tuple(m.input_shape) == tuple(jm.input_shape)
    assert str(m.input_dtype).split(".")[-1] == jnp.dtype(jm.input_dtype).name
    p = m.init(t_rng.purpose_key(t_rng.root_key(0), "init"))
    x = torch.zeros((2,) + tuple(m.input_shape), dtype=m.input_dtype)
    out = m.apply(p, x)
    # the reference's output shape, traced only (no compile, no run)
    want = jax.eval_shape(lambda: jm.apply(
        jm.init(jax.random.PRNGKey(0)),
        jnp.zeros((2,) + tuple(jm.input_shape), jm.input_dtype)))
    assert out.shape == want.shape and torch.isfinite(out).all(), name


def test_unknown_and_unported_names_raise():
    for name in ("vit", "gan", "resnet34"):
        with pytest.raises(NotImplementedError, match=name):
            t_hub.create(t_arguments().update(model=name), 10)


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


#: the cifar100_resnet18 row of tools/run_baseline_rows.py (FedProx μ 0.1,
#: Dirichlet α 0.5, batch 20, lr 0.05) at width 8 on 160 images
CIFAR_ROW_SMALL = dict(dataset="cifar100", model="resnet18_gn_w8",
                       federated_optimizer="FedProx", fedprox_mu=0.1,
                       client_num_in_total=8, client_num_per_round=2,
                       batch_size=20, learning_rate=0.05,
                       partition_method="hetero", partition_alpha=0.5,
                       train_size=160, test_size=40, epochs=1,
                       frequency_of_the_test=10 ** 9, random_seed=0)


def test_fedprox_rounds_match_jax():
    japi, tapi = _pair(dict(CIFAR_ROW_SMALL, comm_round=2))
    for r in range(2):
        jm, tm = japi.train_one_round(r), tapi.train_one_round(r)
        assert float(tm["total_steps"]) == float(jm["total_steps"])
        assert abs(float(tm["train_loss"]) - float(jm["train_loss"])) \
            < ROUND_TOL
    ref = from_flax(jax.device_get(japi.state.global_params), tapi.model,
                    device="cpu")
    for k, v in tapi.state.global_params.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0,
                                   atol=ROUND_TOL, err_msg=k)


@pytest.mark.parametrize("name", ["resnet18", "resnet18_gn_w8", "resnet20",
                                  "resnet56"])
def test_run_simulation_trains_the_resnets(name):
    """``run_simulation(backend="sp")`` creates and trains each ResNet name
    on the CPU when asked: finite params that moved."""
    args = t_arguments().update(**dict(
        CIFAR_ROW_SMALL, model=name, train_size=40, test_size=8,
        client_num_in_total=4, comm_round=1, batch_size=10,
        frequency_of_the_test=1))
    start = t_model.create(args, 100).init(
        t_rng.purpose_key(t_rng.root_key(0), "init"))
    params = fedml_tpu_torch.run_simulation(backend="sp", args=args,
                                            device="cpu")
    for k, v in params.items():
        assert torch.isfinite(v).all(), k
    assert all(not torch.equal(v, start[k]) for k, v in params.items())
