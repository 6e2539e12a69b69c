"""The GroupNorm VGGs, MobileNetV3, EfficientNet-lite and the GCN against
the JAX package's, on the CPU.

- Models: the flax module and the port's at the same weights
  (``models/convert.py``) on the same numpy inputs: logits, the mean
  cross-entropy and its gradient with respect to every parameter within
  1e-5 (absolute, and relative to the largest entry of the tensor), for
  ``vgg11`` (32×32×3), ``vgg16`` (16×16×1, where the last pools are
  skipped), ``mobilenet``, ``efficientnet`` and the packed ``gcn``.
- flax's ``SAME`` rule for a 5×5 stride-2 depthwise convolution on an even
  size, (1, 2), is pinned against ``flax.linen.Conv`` itself.
- The GCN's numpy helpers are bitwise the JAX package's; the packed model
  equals the unpacked one (``tests/test_model_zoo_ext.py::
  test_gcn_hub_entry_packed``), and a federated GCN learns the synthetic
  graphs (``::test_gcn_federated_graph_classification``'s bar, 0.6).
- Rounds: two FedAvg rounds of ``mobilenet`` against the JAX
  ``FedAvgAPI`` from the same weights, params and losses within 1e-4:
  GroupNorm over the 2×2 maps of the last blocks divides by a variance of
  four numbers, which amplifies f32 rounding step by step (2.7e-5
  measured after two rounds).
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
from fedml_tpu.models import gcn as j_gcn
from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI

from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.core import rng as t_rng
from fedml_tpu_torch.ml.trainer.local_trainer import \
    cross_entropy_loss as t_xent
from fedml_tpu_torch.models import gcn as t_gcn
from fedml_tpu_torch.models.convert import from_flax, to_flax
from fedml_tpu_torch.models.resnet import ConvSame
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvgAPI

TOL = 1e-5
#: two f32 mobilenet rounds (see the module docstring)
ROUND_TOL = 1e-4


@pytest.fixture(autouse=True)
def _few_torch_threads():
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


CASES = [
    # model, input_shape, classes
    ("vgg11", (32, 32, 3), 10),
    ("vgg16", (16, 16, 1), 7),
    ("mobilenet", (32, 32, 3), 10),
    ("efficientnet", (32, 32, 3), 10),
    ("gcn", None, 3),
]


def _models(name, shape, classes):
    args = types.SimpleNamespace(model=name, dataset="x", input_shape=shape,
                                 max_nodes=12, node_feature_dim=8)
    return j_model.create(args, classes), t_model.create(args, classes)


def _inputs(jm, classes, batch=2):
    rng = np.random.default_rng(0)
    if jm.input_shape[-1] == jm.input_shape[0] + 8 + 1:   # the packed GCN
        x, adj, mask, _ = j_gcn.synthetic_graph_classification(batch, 12, 8,
                                                               classes)
        x = j_gcn.pack_graph_batch(x, adj, mask)
    else:
        x = rng.random((batch,) + tuple(jm.input_shape), np.float32)
    return x, rng.integers(0, classes, batch)


@pytest.mark.parametrize("name,shape,classes", CASES)
def test_forward_and_gradients_match_flax(name, shape, classes):
    jm, tm = _models(name, shape, classes)
    assert tuple(tm.input_shape) == tuple(jm.input_shape)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    tp = from_flax(jp, tm, device="cpu")
    x, y = _inputs(jm, classes)

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(x))
        return j_xent(logits, jnp.asarray(y)), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)

    def tloss(p):
        logits = tm.apply(p, torch.tensor(x))
        return t_xent(logits, torch.tensor(y)), logits

    tg, (tl, tlogits) = torch.func.grad_and_value(tloss, has_aux=True)(tp)
    _close(tlogits, jlogits, "logits")
    _close(tl, jl, "loss")
    ref = from_flax(jax.device_get(jg), tm, device="cpu")
    for k in tp:
        _close(tg[k], ref[k].numpy(), f"grad {k}")


@pytest.mark.parametrize("name,shape,classes", CASES)
def test_convert_round_trip_and_init(name, shape, classes):
    jm, tm = _models(name, shape, classes)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    back = to_flax(from_flax(jp, tm, device="cpu"), tm)
    flat = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)
    tp = tm.init(t_rng.purpose_key(t_rng.root_key(0), "init"))
    ref = from_flax(jp, tm, device="cpu")
    assert tp.keys() == ref.keys()
    assert all(tp[k].shape == ref[k].shape for k in tp)


def test_depthwise_same_padding_matches_flax_conv():
    """A 5×5 stride-2 depthwise convolution on an even size pads (1, 2)
    under flax's SAME rule, as flax's own ``Conv`` computes it."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    conv = fnn.Conv(6, (5, 5), strides=(2, 2), padding="SAME",
                    feature_group_count=6, use_bias=True)
    p = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = conv.apply(p, jnp.asarray(x))
    port = ConvSame(6, 6, 5, 2, bias=True, groups=6)
    w = np.asarray(p["params"]["kernel"]).transpose(3, 2, 0, 1)
    got = torch.func.functional_call(
        port, {"weight": torch.tensor(np.ascontiguousarray(w)),
               "bias": torch.tensor(np.asarray(p["params"]["bias"]))},
        (torch.tensor(x).permute(0, 3, 1, 2),)).permute(0, 2, 3, 1)
    _close(got, want, "depthwise 5x5/2")


def test_unknown_vgg_raises_value_error():
    with pytest.raises(ValueError, match="vgg variants"):
        t_model.create(types.SimpleNamespace(model="vgg12", dataset="x"), 10)


@pytest.mark.parametrize("seed", [0, 3])
def test_graph_helpers_bitwise(seed):
    a = j_gcn.synthetic_graph_classification(9, 10, 5, 3, seed=seed)
    b = t_gcn.synthetic_graph_classification(9, 10, 5, 3, seed=seed)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(j_gcn.pack_graph_batch(*a[:3]),
                                  t_gcn.pack_graph_batch(*b[:3]))
    adj = (np.random.default_rng(seed).random((2, 6, 6)) < 0.4).astype(
        np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1] * 6], np.float32)
    np.testing.assert_array_equal(j_gcn.normalize_adjacency(adj, mask),
                                  t_gcn.normalize_adjacency(adj, mask))


def test_gcn_hub_entry_packed():
    """Mirror of ``tests/test_model_zoo_ext.py::test_gcn_hub_entry_packed``:
    the packed hub model equals the raw-tuple classifier on the same
    params."""
    n_nodes, feat = 12, 8
    args = types.SimpleNamespace(model="gcn", dataset="x",
                                 max_nodes=n_nodes, node_feature_dim=feat)
    m = t_model.create(args, 3)
    p = m.init(t_rng.root_key(0))
    x, adj, mask, _ = t_gcn.synthetic_graph_classification(6, n_nodes, feat,
                                                           3)
    packed = t_gcn.pack_graph_batch(x, adj, mask)
    assert packed.shape == (6, n_nodes, n_nodes + feat + 1)
    out = m.apply(p, torch.tensor(packed))
    assert out.shape == (6, 3)
    raw = t_gcn.GCNGraphClassifier(3, feat, hidden=64, n_layers=2)
    raw_out = torch.func.functional_call(
        raw, {k[len("gcn."):]: v for k, v in p.items()},
        ((torch.tensor(x), torch.tensor(adj), torch.tensor(mask)),))
    torch.testing.assert_close(out, raw_out, rtol=1e-5, atol=1e-5)


def test_gcn_federated_graph_classification():
    """Mirror of ``tests/test_model_zoo_ext.py::
    test_gcn_federated_graph_classification``: 3 clients, 5 FedAvg rounds
    of 8 Adam steps (lr 5e-3) on their graph shards; held-out accuracy
    above 0.6 (chance 1/3)."""
    classes, n_nodes, n_feats = 3, 12, 8
    x, adj, mask, y = t_gcn.synthetic_graph_classification(
        360, n_nodes, n_feats, classes, seed=0)
    data = [torch.tensor(a) for a in (x, adj, mask, y)]
    train = [a[:300] for a in data]
    test = [a[300:] for a in data]
    torch.manual_seed(0)
    model = t_gcn.GCNGraphClassifier(classes, n_feats, hidden=32)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}

    def loss_fn(p, xb, ab, mb, yb):
        logits = torch.func.functional_call(model, p, ((xb, ab, mb),))
        return torch.nn.functional.cross_entropy(logits, yb)

    for _ in range(5):
        local = []
        for i in range(3):
            shard = [a[i::3] for a in train]
            p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            opt = torch.optim.Adam(p.values(), lr=5e-3)
            for _ in range(8):
                opt.zero_grad()
                loss_fn(p, *shard).backward()
                opt.step()
            local.append(p)
        params = {k: sum(q[k].detach() for q in local) / 3 for k in params}
    logits = torch.func.functional_call(model, params, (tuple(test[:3]),))
    acc = float((logits.argmax(-1) == test[3]).float().mean())
    assert acc > 0.6, acc


def test_mobilenet_rounds_match_jax():
    cfg = dict(dataset="cifar10", model="mobilenet", client_num_in_total=4,
               client_num_per_round=2, batch_size=4, learning_rate=0.05,
               partition_method="homo", train_size=32, test_size=8,
               comm_round=2, epochs=1, frequency_of_the_test=10 ** 9,
               random_seed=0)
    jargs = j_arguments().update(**cfg)
    jds, jn = j_data.load(jargs)
    japi = JFedAvgAPI(jargs, None, jds, j_model.create(jargs, jn))
    targs = t_arguments().update(**cfg)
    tds, tn = t_data.load(targs)
    tm = t_model.create(targs, tn)
    tapi = TFedAvgAPI(targs, "cpu", tds, tm)
    tapi.state = tapi.state.replace(global_params=from_flax(
        jax.device_get(japi.state.global_params), tm, device="cpu"))
    for r in range(2):
        jm, tmr = japi.train_one_round(r), tapi.train_one_round(r)
        assert abs(float(tmr["train_loss"]) - float(jm["train_loss"])) \
            < ROUND_TOL
    ref = from_flax(jax.device_get(japi.state.global_params), tm,
                    device="cpu")
    for k, v in tapi.state.global_params.items():
        _close(v, ref[k].numpy(), k, tol=ROUND_TOL)
