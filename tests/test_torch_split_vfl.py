"""The port's split learning, vertical FL and centralized trainer against
the JAX package's classes, on the CPU, from the same weights, and every
engine of this family on the card unless the CPU is asked for.

- Split NN: the three protocol stages (client forward, the server's step
  returning dL/dh, the client's backward by VJP) against the JAX jitted
  ones, batch by batch, and ``tests/test_algorithms.py::test_split_nn``'s
  run: losses and params within 1e-5, its bars.
- Vertical FL: one guest step (loss and ∂L/∂logit) and one party update,
  and ``tests/test_algorithms.py::test_vertical_fl``'s run: losses,
  weights and accuracy within 1e-5, its bar.
- ``CentralizedTrainer`` (sgd and adam): ``tests/test_compression.py::
  test_centralized_trainer``'s run, each epoch's record within 1e-5 and
  the final params within 1e-5 (sgd) and 1e-4 (adam: it normalises the
  rounding noise of near-zero gradients into steps of up to lr, 0.1), its
  bars.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import flax.linen as fnn

from fedml_tpu import data as j_data
from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.data.federated_dataset import build_federated as j_build
from fedml_tpu.data.synthetic import synthetic_image_classification
from fedml_tpu.models.model_hub import create as j_create
from fedml_tpu.simulation.centralized_trainer import \
    CentralizedTrainer as JCentral
from fedml_tpu.simulation.sp.split_nn import SplitNNAPI as JSplit
from fedml_tpu.simulation.sp.vertical_fl import VerticalFLAPI as JVFL

from fedml_tpu_torch import data as t_data
from fedml_tpu_torch.data.federated_dataset import build_federated as t_build
from fedml_tpu_torch.models import vfl as t_vfl
from fedml_tpu_torch.models.base import TorchModel
from fedml_tpu_torch.models.convert import from_flax
from fedml_tpu_torch.models.model_hub import create as t_create
from fedml_tpu_torch.simulation.centralized_trainer import \
    CentralizedTrainer as TCentral
from fedml_tpu_torch.simulation.sp import fedgan, fedgkt, fednas, fedseg
from fedml_tpu_torch.simulation.sp.split_nn import SplitNNAPI as TSplit
from fedml_tpu_torch.simulation.sp.vertical_fl import VerticalFLAPI as TVFL

from .torch_sp_parity import base_args, tree_close

TOL = 1e-5


@pytest.fixture(autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# -- split NN -------------------------------------------------------------

class JBottom(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = x.reshape((x.shape[0], -1))
        return fnn.relu(fnn.Dense(32)(x))


class JTop(fnn.Module):
    @fnn.compact
    def __call__(self, h):
        return fnn.Dense(10)(h)


class Bottom(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.Dense_0 = nn.Linear(d, 32)

    def forward(self, x):
        return F.relu(self.Dense_0(x.reshape(x.shape[0], -1)))


class Top(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(32, 10)

    def forward(self, h):
        return self.Dense_0(h)


def _split_pair():
    """``tests/test_algorithms.py::test_split_nn``'s configuration."""
    args = base_args(comm_round=3, batch_size=32, learning_rate=0.2,
                     client_num_in_total=1, partition_method="homo")
    (jds, _), (tds, _) = j_data.load(args), t_data.load(args)
    japi = JSplit(args, jds, JBottom(), JTop())
    tapi = TSplit(args, tds, Bottom(14 * 14), Top(), device="cpu")
    for side, mod in (("client", Bottom(14 * 14)), ("server", Top())):
        setattr(tapi, f"{side}_params", from_flax(
            jax.device_get(getattr(japi, f"{side}_params")),
            TorchModel(mod, ()), device="cpu"))
    return japi, tapi


def test_split_nn_stages_match_jax():
    japi, tapi = _split_pair()
    xb, yb = japi.dataset.client_batches(0, 32, japi.seed, 0, 1)
    cm, sm = TorchModel(Bottom(14 * 14), ()), TorchModel(Top(), ())
    jc, js, joc, jos = (japi.client_params, japi.server_params, japi.opt_c,
                        japi.opt_s)
    tc, ts, toc, tos = (tapi.client_params, tapi.server_params, tapi.opt_c,
                        tapi.opt_s)
    for s in range(3):
        x, y = xb[s], yb[s]
        jh = japi._client_forward(jc, jnp.asarray(x))
        th = tapi.client_forward(tc, torch.tensor(x))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL)
        jl, js, jos, jgh = japi._server_step(js, jos, jh, jnp.asarray(y))
        tl, ts, tos, tgh = tapi.server_step(ts, tos, th, torch.tensor(y))
        assert abs(float(tl) - float(jl)) <= TOL
        np.testing.assert_allclose(tgh.numpy(), np.asarray(jgh), atol=TOL)
        jc, joc = japi._client_backward(jc, joc, jnp.asarray(x), jgh)
        tc, toc = tapi.client_backward(tc, toc, torch.tensor(x), tgh)
        tree_close(tc, jc, cm, f"client step {s}")
        tree_close(ts, js, sm, f"server step {s}")


def test_split_nn_matches_jax_and_learns():
    """``tests/test_algorithms.py::test_split_nn`` on the port, from the
    JAX class's weights; ``fuse`` is accepted and changes nothing."""
    japi, tapi = _split_pair()
    acc0 = tapi.evaluate()
    assert abs(acc0 - japi.evaluate()) <= TOL
    jl, tl = japi.train(), tapi.train()
    assert len(tl) == len(jl)
    np.testing.assert_allclose(tl, jl, atol=TOL)
    tree_close(tapi.client_params, japi.client_params,
               TorchModel(Bottom(14 * 14), ()), "client")
    tree_close(tapi.server_params, japi.server_params, TorchModel(Top(), ()),
               "server")
    acc1 = tapi.evaluate()
    assert abs(acc1 - japi.evaluate()) <= TOL
    assert tl[-1] < tl[0]
    assert acc1 > max(acc0, 0.4)
    fused = TSplit(tapi.args, tapi.dataset, Bottom(14 * 14), Top(),
                   fuse=True, device="cpu")
    assert all(torch.equal(fused.client_params[k], v) for k, v in
               TSplit(tapi.args, tapi.dataset, Bottom(14 * 14), Top(),
                      device="cpu").client_params.items())


# -- vertical FL ----------------------------------------------------------

def _vfl_pair():
    """``tests/test_algorithms.py::test_vertical_fl``'s configuration."""
    tx, ty, vx, vy = synthetic_image_classification(2000, 400, 4, (16,), 3)
    args = j_arguments().update(batch_size=64, comm_round=15,
                                learning_rate=0.5, random_seed=3)
    parts = ([tx[:, :8], tx[:, 8:]], ty, [vx[:, :8], vx[:, 8:]], vy)
    japi = JVFL(args, *parts, num_classes=4)
    tapi = TVFL(args, *parts, num_classes=4, device="cpu")
    for jp, tp in zip(japi.parties, tapi.parties):
        assert tuple(tp.w.shape) == jp.w.shape
        tp.w = torch.tensor(np.asarray(jp.w))
    return japi, tapi


def test_vertical_fl_step_matches_jax():
    japi, tapi = _vfl_pair()
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 4)).astype(np.float32)
    y = rng.integers(0, 4, 6)
    jl, jg = japi._guest_grad(jnp.asarray(logits), jnp.asarray(y))
    tl, tg = tapi.guest_grad(torch.tensor(logits), torch.tensor(y))
    assert abs(float(tl) - float(jl)) <= TOL
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=TOL)
    x = japi.features[0][:6]
    np.testing.assert_allclose(
        tapi.parties[0].forward(torch.tensor(x)).numpy(),
        np.asarray(japi.parties[0].forward(jnp.asarray(x))), atol=TOL)
    japi.parties[0].backward(jnp.asarray(x), jg)
    tapi.parties[0].backward(torch.tensor(x), tg)
    np.testing.assert_allclose(tapi.parties[0].w.numpy(),
                               np.asarray(japi.parties[0].w), atol=TOL)


def test_vertical_fl_matches_jax_and_learns():
    japi, tapi = _vfl_pair()
    acc0 = tapi.evaluate()
    assert acc0 == japi.evaluate()
    jl, tl = japi.train(), tapi.train()
    assert len(tl) == len(jl) == 15 * (2000 // 64)
    np.testing.assert_allclose(tl, jl, atol=TOL)
    for jp, tp in zip(japi.parties, tapi.parties):
        np.testing.assert_allclose(tp.w.numpy(), np.asarray(jp.w), atol=TOL)
    acc1 = tapi.evaluate()
    assert abs(acc1 - japi.evaluate()) <= TOL
    assert acc1 > max(acc0, 0.5), (acc0, acc1)


# -- the centralized trainer ----------------------------------------------

@pytest.mark.parametrize("opt,tol", [("sgd", TOL), ("adam", 1e-4)])
def test_centralized_trainer_matches_jax(opt, tol):
    """``tests/test_compression.py::test_centralized_trainer`` on the port,
    from the JAX trainer's weights."""
    rng = np.random.default_rng(0)
    n, d = 512, 16
    w = rng.normal(size=(d, 2)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x @ w).argmax(-1).astype(np.int64)
    xt = rng.normal(size=(128, d)).astype(np.float32)
    yt = (xt @ w).argmax(-1).astype(np.int64)
    args = types.SimpleNamespace(
        model="lr", input_shape=(d,), batch_size=32, epochs=6,
        learning_rate=0.1, client_optimizer=opt, random_seed=0,
        frequency_of_train_acc_report=2)
    jtr = JCentral(j_build(x, y, xt, yt, 2, client_num=4, method="homo",
                           alpha=0.5, seed=0), j_create(args, 2), None, args)
    model = t_create(args, 2)
    ttr = TCentral(t_build(x, y, xt, yt, 2, client_num=4, method="homo",
                           alpha=0.5, seed=0), model, "cpu", args)
    ttr.params = from_flax(jax.device_get(jtr.params), model, device="cpu")
    ttr.opt_state = ttr.tx.init(ttr.params)
    jh, th = jtr.train(), ttr.train()
    assert len(th) == 6
    for j, t in zip(jh, th):
        assert t.keys() == j.keys()
        for k in j:
            assert abs(t[k] - j[k]) <= TOL, (k, t, j)
    tree_close(ttr.params, jtr.params, model, "params", tol)
    assert th[-1]["test_acc"] > 0.8
    assert th[-1]["train_loss"] < th[0]["train_loss"]


# -- the card by default --------------------------------------------------

def test_engines_run_on_the_card_unless_asked(monkeypatch):
    """No fallback: without CUDA each engine, and each VFL party, built
    with no device raises; ``device="cpu"`` is taken only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = base_args(dataset="synthetic", input_shape=(8, 8, 1),
                     num_classes=3, train_size=64, test_size=16,
                     client_num_in_total=4, model="darts")
    ds, n_out = t_data.load(args)
    model = t_create(args, n_out)
    idxs = [ds.client_idxs[c] for c in range(4)]
    feats = [np.zeros((8, 3), np.float32)] * 2
    builds = {
        "fednas": lambda **kw: fednas.FedNASAPI(args, ds, model, **kw),
        "fedseg": lambda **kw: fedseg.FedSegAPI(args, ds, model, **kw),
        "fedgkt": lambda **kw: fedgkt.FedGKTAPI(args, ds, **kw),
        "fedgan": lambda **kw: fedgan.FedGANAPI(args, ds.train_x, idxs,
                                                **kw),
        "split_nn": lambda **kw: TSplit(args, ds, Bottom(64), Top(), **kw),
        "vertical_fl": lambda **kw: TVFL(args, feats, np.zeros(8, np.int64),
                                         feats, np.zeros(8, np.int64), 2,
                                         **kw),
        "centralized": lambda **kw: TCentral(ds, model, kw.get("device"),
                                             args),
        "vfl_party": lambda **kw: t_vfl.VFLClassifier(3, 2, 0.1, **kw),
    }
    for name, build in builds.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(device=None)
        assert build(device="cpu").device == torch.device("cpu"), name
