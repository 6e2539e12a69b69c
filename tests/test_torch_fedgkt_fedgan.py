"""The port's FedGKT and FedGAN engines against the JAX package's, on the
CPU, from the same weights (``models/convert.py``) on the same data.

FedGAN's latent noise is an input of the port's ``client_train``; the
tests rebuild the JAX engine's threefry chain with ``jax.random`` (the
engine's root key ``random_seed + 7``, one split a client, three a step)
and hand the port the same z.

- One client's local functions against the JAX engine's jitted ones:
  FedGKT's ``client_train`` (with the KD term switched on for some steps
  and off for others) and ``server_train`` (twice, carrying Adam's state),
  and FedGAN's ``client_train``.  Per-step losses, SGD-trained params and
  the client extractor's outputs within 1e-5.  What Adam trains (FedGKT's
  server head, FedGAN's G and D) is held to 1e-4: Adam normalises the f32
  rounding noise of an entry whose gradient is near zero into a step of up
  to lr (1e-3 for the server head, 2e-4 for the GAN), which one entry in
  65,536 of the server head shows (2.7e-5 measured; 1.9e-5 on FedGAN's D
  after two rounds).
- Whole runs through ``run_simulation(backend="sp", device="cpu")``
  against ``fedml_tpu.run_simulation``: FedGKT 3 rounds (history and every
  client's nets within 1e-5, the server head within 1e-4; 1.3e-6
  measured) and FedGAN 2 rounds (history within 1e-5, G and D within
  1e-4).
- The JAX oracles' bars (``tests/test_model_zoo_ext.py``): FedGKT's server
  loss falls and its accuracy passes 0.5; FedGAN's samples lie in
  [−1, 1].
"""

import types

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.simulation.sp.fedgan import FedGANAPI as JGAN
from fedml_tpu.simulation.sp.fedgkt import FedGKTAPI as JGKT

from fedml_tpu_torch.models.convert import from_flax
from fedml_tpu_torch.simulation.sp.fedgan import FedGANAPI as TGAN
from fedml_tpu_torch.simulation.sp.fedgkt import FedGKTAPI as TGKT

from .torch_engine_parity import datasets, history_close, run_both
from .torch_sp_parity import tree_close

TOL = 1e-5
#: what Adam trains (see the module docstring)
ADAM_TOL = 1e-4


@pytest.fixture(autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _state_close(got, jstate, model, what, tol=TOL):
    """The port's optimizer state dict against optax's (trace, or Adam's
    mu/nu/count), inside a chain or not."""
    inner = jstate[0] if isinstance(jstate, tuple) else jstate
    if hasattr(inner, "trace"):
        trees = {"trace": inner.trace}
    else:
        trees = {"mu": inner.mu, "nu": inner.nu}
        assert int(got["count"]) == int(inner.count), what
    for p, t in trees.items():
        tree_close({k[len(p) + 1:]: v for k, v in got.items()
                    if k.startswith(p + "/")}, t, model, f"{what} {p}", tol)


# -- FedGKT ---------------------------------------------------------------

def _carry_gkt(start, tapi):
    tapi._init_e = from_flax(start["_init_e"], tapi.extractor, device="cpu")
    tapi._init_h = from_flax(start["_init_h"], tapi.c_head, device="cpu")
    tapi.s_params = from_flax(start["s_params"], tapi.s_head, device="cpu")


def _gkt_pair(**over):
    jds, tds = datasets("img", n=96, hw=8, n_clients=3)
    args = types.SimpleNamespace(**dict(dict(
        comm_round=3, batch_size=8, random_seed=0, learning_rate=0.05),
        **over))
    japi = JGKT(args, jds)
    tapi = TGKT(args, tds, device="cpu")
    _carry_gkt({k: jax.device_get(getattr(japi, k))
                for k in ("_init_e", "_init_h", "s_params")}, tapi)
    return japi, tapi


def test_fedgkt_client_and_server_steps_match_jax():
    japi, tapi = _gkt_pair()
    rng = np.random.default_rng(0)
    (xb, yb), _ = japi._batches(1, 2)
    steps, bs = yb.shape
    sl = rng.standard_normal((steps, bs, 3)).astype(np.float32)
    has = (np.arange(steps) % 2).astype(np.float32)     # KD on odd steps
    jp, jl = japi._client_train((japi._init_e, japi._init_h), (xb, yb),
                                (sl, has))
    tp, tl = tapi.client_train((tapi._init_e, tapi._init_h),
                               tapi._batches(1, 2),
                               (torch.tensor(sl), torch.tensor(has)))
    tree_close(tp[0], jp[0], tapi.extractor, "extractor")
    tree_close(tp[1], jp[1], tapi.c_head, "head")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    f, cl = japi._client_extract(jp[0], jp[1],
                                 xb.reshape((-1,) + xb.shape[2:]))
    tf, tcl = tapi.client_extract(*tp, torch.tensor(xb).flatten(0, 1))
    np.testing.assert_allclose(tf.numpy(), np.asarray(f), atol=TOL)
    np.testing.assert_allclose(tcl.numpy(), np.asarray(cl), atol=TOL)
    feats = rng.standard_normal((steps, bs, 64)).astype(np.float32)
    js, jo, ts, to = japi.s_params, japi.opt_s, tapi.s_params, tapi.opt_s
    for _ in range(2):      # Adam's state carries from one bank to the next
        js, jo, jl = japi._server_train(js, jo, feats, yb, sl)
        ts, to, tl = tapi.server_train(ts, to, torch.tensor(feats),
                                       torch.tensor(yb), torch.tensor(sl))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    tree_close(ts, js, tapi.s_head, "server head", ADAM_TOL)
    _state_close(to, jo, tapi.s_head, "server Adam")


def test_fedgkt_knowledge_transfer():
    """``tests/test_model_zoo_ext.py::test_fedgkt_knowledge_transfer`` on
    the port, from that test's weights."""
    _, tapi = _gkt_pair()
    out = tapi.train()
    assert len(out["history"]) == 3
    assert (out["history"][-1]["server_loss"]
            < out["history"][0]["server_loss"] + 1e-6)
    assert tapi.evaluate() > 0.5


# -- FedGAN ---------------------------------------------------------------

def jax_noise(seed: int, latent: int):
    """The JAX engine's z, client by client, as the port's
    ``client_noise(steps, batch)`` gives them: ``(steps, 2, B, latent)``."""
    key = [jax.random.PRNGKey(seed + 7)]

    def draw(steps, batch):
        key[0], k = jax.random.split(key[0])
        return torch.tensor(np.stack([_step_noise(k, batch, latent, s)
                                      for s in range(steps)]))

    return draw


def _step_noise(k, batch, latent, step):
    for _ in range(step + 1):
        k, k1, k2 = jax.random.split(k, 3)
    return np.stack([np.asarray(jax.random.normal(k1, (batch, latent))),
                     np.asarray(jax.random.normal(k2, (batch, latent)))])


def _carry_gan(start, tapi):
    tapi.g_params = from_flax(start["g_params"], tapi.gen, device="cpu")
    tapi.d_params = from_flax(start["d_params"], tapi.disc, device="cpu")
    tapi.client_noise = jax_noise(tapi.seed, tapi.latent_dim)


def _gan_pair(hw=8):
    rng = np.random.default_rng(0)
    images = (rng.standard_normal((64, hw, hw, 1)) * 0.1).astype(np.float32)
    idxs = [np.arange(c, 64, 4) for c in range(4)]
    args = types.SimpleNamespace(comm_round=2, batch_size=8,
                                 client_num_per_round=2, random_seed=0,
                                 learning_rate=2e-4)
    japi = JGAN(args, images, idxs)
    tapi = TGAN(args, images, idxs, device="cpu")
    _carry_gan({k: jax.device_get(getattr(japi, k))
                for k in ("g_params", "d_params")}, tapi)
    return japi, tapi


def test_fedgan_client_train_matches_jax_with_its_noise():
    japi, tapi = _gan_pair()
    batches = japi._client_batches(2, 1)
    key = jax.random.PRNGKey(11)
    jg, jd, (jdl, jgl) = japi._client_train(japi.g_params, japi.d_params,
                                            batches, key)
    z = torch.tensor(np.stack([_step_noise(key, 8, 64, s)
                               for s in range(batches.shape[0])]))
    tg, td, (tdl, tgl) = tapi.client_train(tapi.g_params, tapi.d_params,
                                           torch.tensor(batches), z)
    tree_close(tg, jg, tapi.gen, "G", ADAM_TOL)
    tree_close(td, jd, tapi.disc, "D", ADAM_TOL)
    np.testing.assert_allclose(tdl.numpy(), np.asarray(jdl), atol=TOL)
    np.testing.assert_allclose(tgl.numpy(), np.asarray(jgl), atol=TOL)


def test_fedgan_trains():
    """``tests/test_model_zoo_ext.py::test_fedgan_trains`` on the port (its
    28×28 images), from the JAX engine's weights."""
    japi, tapi = _gan_pair(hw=28)
    out = tapi.train()
    assert len(out["history"]) == 2
    assert np.isfinite(out["history"][-1]["g_loss"])
    samples = tapi.sample(3)
    assert samples.shape == (3, 28, 28, 1)
    assert np.all(np.abs(samples) <= 1.0)
    # from the same z, the samples are the JAX engine's generator's
    z = jax.random.normal(jax.random.PRNGKey(0), (3, 64))
    want = np.asarray(japi.gen.apply({"params": japi.g_params}, z))
    got = tapi.gen.apply(from_flax(jax.device_get(japi.g_params), tapi.gen,
                                   device="cpu"), torch.tensor(np.asarray(z)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


# -- whole runs -----------------------------------------------------------

@pytest.mark.parametrize("engine", ["fedgkt", "fedgan"])
def test_run_simulation_matches_jax(engine):
    cfg = dict(dataset="synthetic", num_classes=3, input_shape=(8, 8, 1),
               model="lr", batch_size=8, train_size=96, test_size=32,
               random_seed=0, partition_method="homo", data_cache_dir="")
    if engine == "fedgkt":
        cfg.update(federated_optimizer="FedGKT", client_num_in_total=3,
                   comm_round=3, learning_rate=0.05)
        jout, tout, japi, tapi = run_both(cfg, JGKT, TGKT, _carry_gkt)
        tree_close(tapi.s_params, japi.s_params, tapi.s_head, "server",
                   ADAM_TOL)
        for c, (e, h) in japi.c_params.items():
            tree_close(tapi.c_params[c][0], e, tapi.extractor, f"e {c}")
            tree_close(tapi.c_params[c][1], h, tapi.c_head, f"h {c}")
        assert tapi.evaluate() == japi.evaluate()
    else:
        cfg.update(federated_optimizer="FedGAN", client_num_in_total=4,
                   client_num_per_round=2, comm_round=2, learning_rate=2e-4)
        jout, tout, japi, tapi = run_both(cfg, JGAN, TGAN, _carry_gan)
        tree_close(tout["g_params"], jout["g_params"], tapi.gen, "G",
                   ADAM_TOL)
        tree_close(tout["d_params"], jout["d_params"], tapi.disc, "D",
                   ADAM_TOL)
    assert tapi.device == torch.device("cpu")
    history_close(tout["history"], jout["history"], TOL)
