"""The models of the other sp engines, and their host-side data and
protocol copies, against the JAX package's on the CPU.

- Forward (and for the trained nets, gradient) parity with carried weights
  (``models/convert.py``) on the same numpy inputs, within 1e-5 absolute,
  relative to the largest entry of the tensor: ``UNetSmall`` (base 8 at
  16×16), ``DARTSNetwork`` (channels 8, steps 2; every primitive weighted,
  both cells, stride 2 on an even and an odd input), ``Generator`` and
  ``Discriminator`` at 8, 16 and 28 px, FedGKT's three nets and ``_kl_to``,
  and the VFL parties (forward, and three ``backward`` updates).
- Exact: ``mean_iou`` (to 1e-7: one f32 division a class), the DARTS
  genotype, and the ``conv_transpose`` conversion's round trip; the
  transposed convolution itself against ``flax.linen.ConvTranspose`` at
  k 4 s 2 and k 2 s 2 (1e-5).
- Bitwise: ``synthetic_segmentation``, ``synthetic_vertical_parties``, the
  segmentation loader (arrays and its dominant-class partition),
  ``load_vertical``, secagg's ``P``/``quantize``/``dequantize`` and
  TurboAggregate's ``aggregate`` and ``observed_partials``.
"""

import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fedml_tpu import model as j_model
from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.core.mpc import secagg as j_secagg
from fedml_tpu.data import data_loader as j_loader
from fedml_tpu.data import synthetic as j_synth
from fedml_tpu.models import darts as j_darts
from fedml_tpu.models import gan as j_gan
from fedml_tpu.models import unet as j_unet
from fedml_tpu.models import vfl as j_vfl
from fedml_tpu.simulation.sp import fedgkt as j_gkt
from fedml_tpu.simulation.sp import turboaggregate as j_turbo

from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.core import rng as t_rng
from fedml_tpu_torch.core.mpc import secagg as t_secagg
from fedml_tpu_torch.data import data_loader as t_loader
from fedml_tpu_torch.data import synthetic as t_synth
from fedml_tpu_torch.models import darts as t_darts
from fedml_tpu_torch.models import gan as t_gan
from fedml_tpu_torch.models import unet as t_unet
from fedml_tpu_torch.models import vfl as t_vfl
from fedml_tpu_torch.models.base import TorchModel
from fedml_tpu_torch.models.convert import from_flax, to_flax
from fedml_tpu_torch.simulation.sp import fedgkt as t_gkt
from fedml_tpu_torch.simulation.sp import turboaggregate as t_turbo

TOL = 1e-5


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


def _carry(jmod, tmod, x, shape):
    """flax params of ``jmod`` initialised on ``x``, and the port's
    TorchModel of ``tmod`` with them."""
    jp = jax.device_get(jax.jit(jmod.init)(jax.random.PRNGKey(3),
                                           jnp.asarray(x))["params"])
    tm = TorchModel(tmod, shape)
    return jp, tm, from_flax(jp, tm, device="cpu")


def _round_trip(jp, tm, tp):
    back = to_flax(tp, tm)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def _forward_and_grad(jmod, jp, tm, tp, x, j_loss, t_loss):
    """Outputs and the gradient of a scalar loss of them, flax vs port."""
    def jf(p):
        out = jmod.apply({"params": p}, jnp.asarray(x))
        return j_loss(out), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jp)

    def tf(p):
        out = tm.apply(p, torch.tensor(x))
        return t_loss(out), out

    tg, (tl, tout) = torch.func.grad_and_value(tf, has_aux=True)(tp)
    _close(tout, jout, "output")
    _close(tl, jl, "loss")
    ref = from_flax(jax.device_get(jg), tm, device="cpu")
    assert tg.keys() == ref.keys()
    for k in tg:
        _close(tg[k], ref[k].numpy(), f"grad {k}")


class _TransposeWrap(nn.Module):
    def __init__(self, cin, cout, k, s):
        super().__init__()
        self.ConvTranspose_0 = t_unet.ConvTransposeSame(cin, cout, k, s)

    def forward(self, x, dropout_masks=None):
        return self.ConvTranspose_0(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _FlaxTranspose(fnn.Module):
    cout: int
    k: int
    s: int

    @fnn.compact
    def __call__(self, x):
        return fnn.ConvTranspose(self.cout, (self.k, self.k),
                                 strides=(self.s, self.s), padding="SAME")(x)


@pytest.mark.parametrize("k,s,hw", [(4, 2, 5), (4, 2, 6), (2, 2, 5),
                                    (2, 2, 4)])
def test_conv_transpose_conversion_matches_flax(k, s, hw):
    """flax's ``ConvTranspose`` (SAME, ``transpose_kernel=False``) convolves
    the dilated input with the kernel as stored; the port's weight is that
    kernel flipped in H and W and transposed.  Output 2·hw, both ways."""
    x = np.random.default_rng(k + hw).standard_normal(
        (2, hw, hw, 3)).astype(np.float32)
    jp, tm, tp = _carry(_FlaxTranspose(5, k, s), _TransposeWrap(3, 5, k, s),
                        x, (hw, hw, 3))
    assert tm.module.ConvTranspose_0.padding == ((k - 2) // 2,) * 2
    _round_trip(jp, tm, tp)
    want = _FlaxTranspose(5, k, s).apply({"params": jp}, jnp.asarray(x))
    got = tm.apply(tp, torch.tensor(x))
    assert got.shape == (2, 2 * hw, 2 * hw, 5)
    _close(got, want, f"ConvTranspose k{k} s{s}")
    with pytest.raises(ValueError, match="not symmetric"):
        t_unet.ConvTransposeSame(3, 5, 3, 2)


def test_unet_forward_and_gradients_match_flax():
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 2)).astype(
        np.float32)
    y = np.random.default_rng(1).integers(0, 3, (2, 16, 16))
    jmod = j_unet.UNetSmall(num_classes=3, base=8)
    jp, tm, tp = _carry(jmod, t_unet.UNetSmall(3, 8, in_channels=2), x,
                        (16, 16, 2))
    _round_trip(jp, tm, tp)
    from fedml_tpu.simulation.sp.fedseg import pixel_cross_entropy as j_ce
    from fedml_tpu_torch.simulation.sp.fedseg import \
        pixel_cross_entropy as t_ce
    _forward_and_grad(jmod, jp, tm, tp, x, lambda o: j_ce(o, jnp.asarray(y)),
                      lambda o: t_ce(o, torch.tensor(y)))


def test_mean_iou_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    labels = rng.integers(0, 3, (3, 8, 8))      # class 3 never a label
    logits[..., 3] -= 10.0                      # ... nor predicted
    for n in (4, 5):
        want = float(j_unet.mean_iou(jnp.asarray(logits), jnp.asarray(labels),
                                     n))
        got = float(t_unet.mean_iou(torch.tensor(logits),
                                    torch.tensor(labels), n))
        assert abs(got - want) <= 1e-7, (n, got, want)


@pytest.mark.parametrize("shape", [(8, 8, 1), (7, 7, 3)])
def test_darts_forward_and_gradients_match_flax(shape):
    """Random alphas weight every primitive; the reduction cell runs every
    op at stride 2 (pads (0, 1) on 8 px, (1, 1) on 7 px)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2,) + shape).astype(np.float32)
    y = rng.integers(0, 3, 2)
    jmod = j_darts.DARTSNetwork(num_classes=3, channels=8, steps=2)
    jp, tm, tp = _carry(jmod, t_darts.DARTSNetwork(3, 8, 2, shape[-1]), x,
                        shape)
    jp = dict(jp)
    for a in ("alphas_normal", "alphas_reduce"):
        assert jp[a].shape == (t_darts.Cell.num_edges(2), 6)
        jp[a] = rng.standard_normal(jp[a].shape).astype(np.float32)
    tp = from_flax(jp, tm, device="cpu")
    _round_trip(jp, tm, tp)
    from fedml_tpu.ml.trainer.local_trainer import cross_entropy_loss as jx
    from fedml_tpu_torch.ml.trainer.local_trainer import \
        cross_entropy_loss as tx
    _forward_and_grad(jmod, jp, tm, tp, x, lambda o: jx(o, jnp.asarray(y)),
                      lambda o: tx(o, torch.tensor(y)))
    assert t_darts.PRIMITIVES == j_darts.PRIMITIVES


def test_derive_genotype_matches_jax():
    rng = np.random.default_rng(5)
    p = {k: rng.standard_normal((6, 6)).astype(np.float32)
         for k in ("alphas_normal", "alphas_reduce")}
    p["alphas_normal"][:, 0] = 9.0     # ``none`` would win every edge
    want = j_darts.derive_genotype(p)
    got = t_darts.derive_genotype({k: torch.tensor(v) for k, v in p.items()})
    assert got == want
    assert "none" not in got["alphas_normal"] + got["alphas_reduce"]


@pytest.mark.parametrize("hw,ch", [(8, 1), (16, 3), (28, 1)])
def test_gan_forward_and_gradients_match_flax(hw, ch):
    rng = np.random.default_rng(hw)
    z = rng.standard_normal((2, 64)).astype(np.float32)
    jg = j_gan.Generator(out_hw=hw, out_channels=ch)
    jp, tm, tp = _carry(jg, t_gan.Generator(hw, ch), z, (64,))
    _round_trip(jp, tm, tp)
    _forward_and_grad(jg, jp, tm, tp, z, lambda o: jnp.sum(o ** 2),
                      lambda o: torch.sum(o ** 2))
    x = rng.uniform(-1, 1, (2, hw, hw, ch)).astype(np.float32)
    jd = j_gan.Discriminator()
    jp, tm, tp = _carry(jd, t_gan.Discriminator(64, hw, ch), x, (hw, hw, ch))
    _round_trip(jp, tm, tp)
    _forward_and_grad(jd, jp, tm, tp, x, lambda o: jnp.sum(o ** 2),
                      lambda o: torch.sum(o ** 2))


def test_gkt_nets_and_kl_match_flax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 8, 8, 1)).astype(np.float32)
    f = rng.standard_normal((3, 64)).astype(np.float32)
    cases = [(j_gkt.ClientExtractor(), t_gkt.ClientExtractor(1), x,
              (8, 8, 1)),
             (j_gkt.ClientHead(num_classes=4), t_gkt.ClientHead(4), f, (64,)),
             (j_gkt.ServerHead(num_classes=4), t_gkt.ServerHead(4), f,
              (64,))]
    for jmod, tmod, inp, shape in cases:
        jp, tm, tp = _carry(jmod, tmod, inp, shape)
        _round_trip(jp, tm, tp)
        _forward_and_grad(jmod, jp, tm, tp, inp, lambda o: jnp.sum(o ** 2),
                          lambda o: torch.sum(o ** 2))
    t, s = (rng.standard_normal((5, 4)).astype(np.float32) for _ in "ts")
    for temp in (1.0, 2.5):
        _close(t_gkt._kl_to(torch.tensor(t), torch.tensor(s), temp),
               j_gkt._kl_to(jnp.asarray(t), jnp.asarray(s), temp), "kl")


@pytest.mark.parametrize("cls", ["VFLFeatureExtractor", "VFLClassifier"])
def test_vfl_parties_match_jax(cls):
    """Forward, and three ``backward`` updates (SGD, momentum 0.9, weight
    decay 0.01) returning dL/dx, from the JAX party's weights."""
    rng = np.random.default_rng(7)
    jparty = getattr(j_vfl, cls)(6, 4, learning_rate=0.1, seed=1)
    tparty = getattr(t_vfl, cls)(6, 4, learning_rate=0.1, seed=1,
                                 device="cpu")
    assert tparty.params.keys() == jparty.params.keys()
    assert all(tuple(tparty.params[k].shape) == jparty.params[k].shape
               for k in tparty.params)
    tparty.params = {k: torch.tensor(np.asarray(v))
                     for k, v in jparty.params.items()}
    for _ in range(3):
        x = rng.standard_normal((5, 6)).astype(np.float32)
        g = rng.standard_normal((5, 4)).astype(np.float32)
        _close(tparty.forward(x), jparty.forward(x), "forward")
        _close(tparty.backward(x, g), jparty.backward(x, g), "dL/dx")
        for k, v in jparty.params.items():
            _close(tparty.params[k], np.asarray(v), k)
    assert t_vfl.DenseModel is t_vfl.VFLClassifier
    assert t_vfl.LocalModel is t_vfl.VFLFeatureExtractor


@pytest.mark.parametrize("name,classes,shape,channels", [
    ("darts", 5, (8, 8, 1), 1), ("darts_search", 10, None, 3),
    ("unet", 3, (8, 8, 1), 1), ("unet_small", 4, (16, 16, 4), 4),
    ("deeplab", 19, (8, 16, 3), 3)])
def test_hub_creates_the_engine_models(name, classes, shape, channels):
    """Each name builds, initialises and forwards, with the reference's
    output shape (traced only) and task."""
    args = types.SimpleNamespace(model=name, dataset="cifar10",
                                 input_shape=shape)
    m, jm = t_model.create(args, classes), j_model.create(args, classes)
    assert tuple(m.input_shape) == tuple(jm.input_shape)
    assert m.input_shape[-1] == channels and m.task == jm.task
    p = m.init(t_rng.purpose_key(t_rng.root_key(0), "init"))
    out = m.apply(p, torch.zeros((2,) + tuple(m.input_shape)))
    want = jax.eval_shape(lambda: jm.apply(
        jm.init(jax.random.PRNGKey(0)), jnp.zeros((2,) + jm.input_shape)))
    assert out.shape == want.shape and torch.isfinite(out).all()


# -- bitwise pins of the host-side copies --------------------------------

@pytest.mark.parametrize("shape,classes", [((16, 16, 4), 4), ((10, 13), 3),
                                           ((64, 128, 3), 19)])
def test_synthetic_segmentation_bitwise(shape, classes):
    a = j_synth.synthetic_segmentation(12, 5, classes, shape, seed=9)
    b = t_synth.synthetic_segmentation(12, 5, classes, shape, seed=9)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("fpp", [7, [634, 1000], [3, 5, 2]])
def test_synthetic_vertical_parties_bitwise(fpp):
    parties = 2 if isinstance(fpp, int) else len(fpp)
    (fa, ya), (fb, yb) = (m.synthetic_vertical_parties(40, parties, fpp, 3,
                                                       seed=2)
                          for m in (j_synth, t_synth))
    np.testing.assert_array_equal(ya, yb)
    assert len(fa) == len(fb) == parties
    for u, v in zip(fa, fb):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("name,over", [
    ("fets2021", dict(input_shape=(16, 16, 4))),
    ("fets", dict(partition_method="homo")),
    ("autonomous_driving", dict(input_shape=(8, 16, 3))),
    ("cityscapes", dict(input_shape=(8, 16, 3), partition_alpha=0.1))])
def test_segmentation_loader_bitwise(name, over):
    cfg = dict(dict(dataset=name, train_size=48, test_size=8,
                    client_num_in_total=4, random_seed=3, data_cache_dir="",
                    partition_method="hetero", partition_alpha=0.5), **over)
    jds, jn = j_loader.load(j_arguments().update(**cfg))
    tds, tn = t_loader.load(t_arguments().update(**cfg))
    assert jn == tn and tds.provenance == jds.provenance == "synthetic"
    for f in ("train_x", "train_y", "test_x", "test_y"):
        u, v = getattr(jds, f), getattr(tds, f)
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)
    assert jds.client_idxs.keys() == tds.client_idxs.keys()
    for c in jds.client_idxs:
        np.testing.assert_array_equal(jds.client_idxs[c], tds.client_idxs[c])


@pytest.mark.parametrize("name,over", [
    ("wine", {}), ("wine", dict(vfl_parties=3, train_size=50)),
    ("breast_cancer", {}), ("nus_wide", {}), ("nus_wide", dict(vfl_parties=3)),
    ("vertical_x", dict(features_per_party=5, num_classes=3))])
def test_load_vertical_bitwise(name, over):
    cfg = dict(dict(dataset=name, random_seed=4, train_size=120), **over)
    (fa, ya, ca), (fb, yb, cb) = (
        m.load_vertical(a().update(**cfg))
        for m, a in ((j_loader, j_arguments), (t_loader, t_arguments)))
    assert ca == cb and len(fa) == len(fb)
    np.testing.assert_array_equal(ya, yb)
    for u, v in zip(fa, fb):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


def test_secagg_field_copy_bitwise():
    assert t_secagg.P == j_secagg.P
    v = np.random.default_rng(0).standard_normal(257) * 300
    q = t_secagg.quantize(v)
    assert q.dtype == j_secagg.quantize(v).dtype
    np.testing.assert_array_equal(q, j_secagg.quantize(v))
    for s in (1 << 16, 1 << 8):
        np.testing.assert_array_equal(t_secagg.quantize(v, s),
                                      j_secagg.quantize(v, s))
        np.testing.assert_array_equal(t_secagg.dequantize(q, s),
                                      j_secagg.dequantize(q, s))


@pytest.mark.parametrize("n,groups,seed", [(7, 3, 5), (5, 5, 0), (9, 2, 1),
                                           (2, 4, 3)])
def test_turboaggregate_copy_bitwise(n, groups, seed):
    """``aggregate`` and the masked partials the server saw are the JAX
    class's bits; the sum is exact to the fixed-point step."""
    updates = [np.random.default_rng(c).standard_normal(17) for c in range(n)]
    assert t_turbo.ring_groups(n, groups) == j_turbo.ring_groups(n, groups)
    j = j_turbo.TurboAggregateAPI(n_clients=n, n_groups=groups, seed=seed)
    t = t_turbo.TurboAggregateAPI(n_clients=n, n_groups=groups, seed=seed)
    want, got = j.aggregate(updates), t.aggregate(updates)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(t.observed_partials) == len(j.observed_partials)
    for u, v in zip(t.observed_partials, j.observed_partials):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_allclose(got, np.sum(updates, axis=0), atol=1e-3)


@pytest.mark.parametrize("name,family", [
    ("imagenet", "large image"), ("imagenet_hdf5", "large image"),
    ("ilsvrc2012", "large image"), ("landmarks", "large image"),
    ("gld23k", "large image"), ("gld160k", "large image"),
    ("edge_case_examples", "edge case"), ("edge_case", "edge case")])
def test_the_datasets_still_unported_raise_by_name(name, family):
    """The segmentation sets load now; the large-image and edge-case sets
    still raise, naming themselves and their family."""
    with pytest.raises(NotImplementedError, match=f"{name}.*{family}"):
        t_loader.load(t_arguments().update(dataset=name, model="lr"))
