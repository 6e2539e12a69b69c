"""The port's CKKS codec and FHE hooks against the JAX package's, on the
CPU.

The ring is exact integer arithmetic, so the port is held bitwise: the
build-time tables and keys, the NTT, ``encrypt`` (the JAX codec's
randomness replaced by a stub, the port's :func:`ckks.draw` by the same
numbers), ``add``, ``scale`` and ``decrypt``, and ``FedMLFHE``'s weighted
FedAvg in ciphertext space.  The decrypted average is also held to the plaintext weighted average within
the scheme's error: the weight quantization (2⁻¹⁷·Σᵢ|xᵢ|), the encoding
(2⁻³⁰), the RLWE error (Σ wᵢ′·max|e| / 2⁴⁶) and the float32 cast of the
result (2⁻²⁴·|avg|).  ``FedMLFHE.init`` resetting the singleton and the
mock codec's two-word Philox key are deliberate divergences, pinned here
in both packages."""

import logging

import numpy as np
import pytest
import torch

from fedml_tpu.core.fhe import ckks as J
from fedml_tpu.core.fhe import fhe_agg as JA
from fedml_tpu_torch.core.fhe import ckks as T
from fedml_tpu_torch.core.fhe import fhe_agg as TA

from .torch_trust_parity import reset_singletons


class _Args:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class _Draws:
    """One encryption's randomness as numpy arrays, served to the JAX
    codec as its ``_rng`` and to the port through ``ckks.draw``, in the
    JAX call order (the error's gaussian, then a uniform a prime)."""

    def __init__(self, rng, chunks):
        self.e = rng.normal(0.0, 3.2, (chunks, J.N))
        self.a = [rng.integers(0, p, (chunks, J.N), dtype=np.int64)
                  for p in J._PRIMES]


class _JaxRng:
    def __init__(self, queue):
        self.queue = queue

    def normal(self, loc, scale, size):
        assert (loc, scale) == (0.0, 3.2)
        d = self.queue[0]
        assert d.e.shape == size
        return d.e

    def integers(self, low, high, size, dtype=None):
        d = self.queue[0]
        a = d.a[J._PRIMES.index(high)]
        if high == J._PRIMES[-1]:
            self.queue.pop(0)
        return a


def _port_draws(monkeypatch, queue):
    """``ckks.draw`` returns the queued draws (and checks what is asked)."""
    def draw(gen, shape, p=None):
        d = queue[0]
        if p is None:
            assert tuple(shape) == d.e.shape
            return torch.from_numpy(d.e.copy())
        a = d.a[T._PRIMES.index(p)]
        assert tuple(shape) == a.shape
        if p == T._PRIMES[-1]:
            queue.pop(0)
        return torch.from_numpy(a.copy())

    monkeypatch.setattr(T, "draw", draw)


def _equal(j_ct, t_ct):
    assert np.array_equal(j_ct.c0, t_ct.c0.numpy())
    assert np.array_equal(j_ct.c1, t_ct.c1.numpy())
    assert (j_ct.scale, j_ct.size) == (t_ct.scale, t_ct.size)


@pytest.mark.parametrize("seed", [0, 3, 0xF4E ^ 11])
def test_tables_and_key_are_bitwise_the_jax_ones(seed):
    assert T._PRIMES == J._PRIMES and T.Q == J.Q
    assert np.array_equal(T._BITREV, J._BITREV)
    for t, j in zip(T._NTT, J._NTT):
        assert t.p == j.p and t.inv_n == j.inv_n
        for name in ("psi_pows", "inv_psi_pows"):
            assert np.array_equal(getattr(t, name), getattr(j, name))
        for a, b in zip(t.stage_w + t.stage_w_inv, j.stage_w + j.stage_w_inv):
            assert np.array_equal(a, b)
    assert np.array_equal(T.CkksCodec(seed)._s_hat_host.numpy(),
                          J.CkksCodec(seed)._s_hat)


def test_ntt_forward_inverse_and_product_are_bitwise():
    rng = np.random.default_rng(1)
    for t, j in zip(T._NTT, J._NTT):
        a = rng.integers(0, t.p, (3, T.N), dtype=np.int64)
        b = rng.integers(0, t.p, (3, T.N), dtype=np.int64)
        ta = torch.from_numpy(a)
        assert np.array_equal(t.fwd(ta).numpy(), j.fwd(a))
        assert np.array_equal(t.inv(ta).numpy(), j.inv(a))
        assert np.array_equal(t.inv(t.fwd(ta)).numpy(), a)
        assert np.array_equal(t.mul(ta, torch.from_numpy(b)).numpy(),
                              j.mul(a, b))


def test_encrypt_add_scale_decrypt_are_bitwise(monkeypatch):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, 2 * T.N + 77).astype(np.float32)
    y = rng.normal(0, 1, x.size).astype(np.float32)
    chunks = -(-x.size // T.N)
    draws = [_Draws(rng, chunks) for _ in range(2)]
    jc, tc = J.CkksCodec(9), T.CkksCodec(9)
    jc._rng = _JaxRng(list(draws))
    _port_draws(monkeypatch, list(draws))
    jx, jy = jc.encrypt(x), jc.encrypt(y)
    tx, ty = tc.encrypt(torch.from_numpy(x)), tc.encrypt(torch.from_numpy(y))
    _equal(jx, tx)
    _equal(jy, ty)
    j_sum = jc.add(jc.scale(jx, 0.3), jc.scale(jy, 0.7))
    t_sum = tc.add(tc.scale(tx, 0.3), tc.scale(ty, 0.7))
    _equal(j_sum, t_sum)
    assert t_sum.nbytes == j_sum.nbytes == 2 * 2 * 8 * T.N * chunks
    assert np.array_equal(tc.decrypt(t_sum).numpy(), jc.decrypt(j_sum))
    assert np.array_equal(tc.decrypt(tx).numpy(), jc.decrypt(jx))
    assert tc._crt_center(t_sum.c0).dtype == torch.int64


def _trees(rng, k=3):
    return [{"w": rng.normal(0, 1, (40, 5)).astype(np.float32),
             "b": rng.normal(0, 1, (5,)).astype(np.float32)}
            for _ in range(k)]


def test_fhe_fedavg_of_a_two_leaf_tree_is_bitwise_and_within_the_bound(
        monkeypatch):
    rng = np.random.default_rng(3)
    trees, ns = _trees(rng), [10.0, 30.0, 25.0]
    draws = [_Draws(rng, 1) for _ in trees]
    args = _Args(enable_fhe=True, random_seed=3)
    jf, tf = JA.FedMLFHE(), TA.FedMLFHE()
    jf.init(args)
    tf.init(args)
    jf.codec._rng = _JaxRng(list(draws))
    log = list(draws)
    _port_draws(monkeypatch, log)
    j_cts = [(n, jf.fhe_enc("local", t)) for n, t in zip(ns, trees)]
    t_cts = [(n, tf.fhe_enc("local", {k: torch.from_numpy(v)
                                      for k, v in t.items()}))
             for n, t in zip(ns, trees)]
    for (_, a), (_, b) in zip(j_cts, t_cts):
        _equal(a, b)
    j_out = jf.fhe_dec("global", jf.fhe_fedavg(j_cts))
    t_out = tf.fhe_dec("global", tf.fhe_fedavg(t_cts))
    assert list(t_out) == ["w", "b"]
    for k in t_out:
        assert t_out[k].dtype == torch.float32
        assert np.array_equal(t_out[k].numpy(), np.asarray(j_out[k]))
    # the plaintext weighted average, float64, and the scheme's bound
    total = sum(ns)
    weights = sum(int(round(n / total * (1 << T.WEIGHT_BITS))) for n in ns)
    e_max = max(np.abs(np.round(d.e)).max() for d in draws)
    for k in t_out:
        xs = [t[k].astype(np.float64) for t in trees]
        ref = sum(n / total * x for n, x in zip(ns, xs))
        got = t_out[k].numpy().astype(np.float64)
        bound = (2.0 ** -17 * sum(np.abs(x) for x in xs) + 2.0 ** -30
                 + weights * e_max / 2.0 ** 46 + 2.0 ** -24 * np.abs(got))
        assert np.all(np.abs(got - ref) <= bound), k
    # a plaintext passes through the decrypt hook unchanged
    plain = {"w": torch.zeros(2)}
    assert tf.fhe_dec("local", plain) is plain


def test_the_mock_codec_masks_additively_and_warns(caplog):
    """The port's mock: payload = x + the Philox mask of ``[seed, size]``
    (float64), merged in payload space, unmasked by the fractional addend
    count.  The JAX mock keys Philox with four words, which numpy refuses:
    its ``encrypt`` raises (pinned, so a repaired reference shows here)."""
    rng = np.random.default_rng(4)
    trees, ns = _trees(rng), [1.0, 2.0, 3.0]
    args = _Args(enable_fhe=True, random_seed=5, fhe_backend="mock")
    jf, tf = JA.FedMLFHE(), TA.FedMLFHE()
    jf.init(args)
    with caplog.at_level(logging.WARNING):
        tf.init(args)
    assert isinstance(tf.codec, TA._AdditiveMaskCodec)
    assert any("NO cryptographic protection" in r.message
               for r in caplog.records)
    with pytest.raises(ValueError, match="key must have 2 elements"):
        jf.fhe_enc("local", trees[0])
    t_cts = [(n, tf.fhe_enc("local", {k: torch.from_numpy(v)
                                      for k, v in t.items()}))
             for n, t in zip(ns, trees)]
    seed = 5 ^ 0xF4E
    for (_, ct), t in zip(t_cts, trees):
        flat = np.concatenate([t["b"], t["w"].ravel()]).astype(np.float64)
        mask = np.random.Generator(np.random.Philox(
            key=[seed, flat.size])).standard_normal(flat.size) * 1e3
        assert np.array_equal(ct.payload, flat + mask)
    t_out = tf.fhe_dec("global", tf.fhe_fedavg(t_cts))
    total = sum(ns)
    for k in t_out:
        ref = sum(n / total * t[k].astype(np.float64)
                  for n, t in zip(ns, trees))
        np.testing.assert_allclose(t_out[k].numpy(), ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="nope"):
        TA.FedMLFHE().init(_Args(enable_fhe=True, fhe_backend="nope"))


def test_no_randomness_reuse_across_clients():
    """Two codecs of one shared seed (two clients) draw different (a, e):
    c1s differ and c0's difference is not the plaintext difference; either
    decrypts the other's ciphertext (one shared secret)."""
    a, b = T.CkksCodec(seed=7), T.CkksCodec(seed=7)
    xa = torch.zeros(T.N, dtype=torch.float64)
    xa[0] = 1.0
    xb = torch.zeros(T.N, dtype=torch.float64)
    xb[0] = 2.0
    ca, cb = a.encrypt(xa), b.encrypt(xb)
    assert not torch.equal(ca.c1, cb.c1)
    p1 = T._PRIMES[0]
    diff = (ca.c0[0, 0] - cb.c0[0, 0]) % p1
    assert int(diff[0]) != (-(1 << T.DELTA_BITS)) % p1
    np.testing.assert_allclose(b.decrypt(ca)[:4].numpy(), xa[:4].numpy(),
                               atol=1e-6)
    # one codec's second encryption draws afresh too
    assert not torch.equal(a.encrypt(xa).c1, ca.c1)


def _frame(pkg):
    if pkg == "jax":
        from fedml_tpu.core.alg_frame.client_trainer import ClientTrainer
        from fedml_tpu.core.alg_frame.server_aggregator import \
            ServerAggregator
    else:
        from fedml_tpu_torch.core.alg_frame.client_trainer import \
            ClientTrainer
        from fedml_tpu_torch.core.alg_frame.server_aggregator import \
            ServerAggregator

    class Trainer(ClientTrainer):
        def get_model_params(self):
            return self.params

        def set_model_params(self, p):
            self.params = p

        def train(self, train_data, device, args):
            return None

    class Aggregator(ServerAggregator):
        def get_model_params(self):
            return None

        def set_model_params(self, p):
            pass

        def aggregate(self, raw):
            from_pkg = (JA if pkg == "jax" else TA).FedMLFHE.get_instance()
            return from_pkg.fhe_fedavg(raw)

        def test(self, test_data, device, args):
            return None

    return Trainer, Aggregator


def test_alg_frame_fhe_hooks_match_jax(monkeypatch):
    """Clients encrypt after local training, the server passes the list
    through, merges in ciphertext space and decrypts; a client decrypts an
    encrypted global model before training; both packages bitwise."""
    from fedml_tpu_torch.arguments import load_arguments as t_arguments

    from fedml_tpu.arguments import load_arguments as j_arguments
    rng = np.random.default_rng(6)
    trees, ns = _trees(rng), [4.0, 5.0, 6.0]
    draws = [_Draws(rng, 1) for _ in range(len(trees) + 1)]
    out = {}
    try:
        for pkg in ("jax", "port"):
            reset_singletons()
            JA.FedMLFHE._instance = TA.FedMLFHE._instance = None
            load = j_arguments if pkg == "jax" else t_arguments
            args = load().update(enable_fhe=True, random_seed=8)
            Trainer, Aggregator = _frame(pkg)
            trainer, agg = Trainer(None, args), Aggregator(None, args)
            fhe = (JA if pkg == "jax" else TA).FedMLFHE.get_instance()
            if pkg == "jax":
                fhe.codec._rng = _JaxRng(list(draws))
            else:
                _port_draws(monkeypatch, list(draws))
            raw = []
            for n, t in zip(ns, trees):
                trainer.set_model_params(
                    t if pkg == "jax" else {k: torch.from_numpy(v)
                                            for k, v in t.items()})
                trainer.on_after_local_training(None, None, args)
                raw.append((n, trainer.get_model_params()))
            passed, _ = agg.on_before_aggregation(raw)
            assert all(a is b for (_, a), (_, b) in zip(passed, raw))
            merged = agg.on_after_aggregation(agg.aggregate(passed))
            # a client receives an encrypted global model
            trainer.set_model_params(fhe.fhe_enc("global", merged))
            trainer.on_before_local_training(None, None, args)
            out[pkg] = (raw, merged, trainer.get_model_params())
    finally:
        reset_singletons()
        JA.FedMLFHE._instance = TA.FedMLFHE._instance = None
    (j_raw, j_merged, j_local), (t_raw, t_merged, t_local) = \
        out["jax"], out["port"]
    for (_, a), (_, b) in zip(j_raw, t_raw):
        _equal(a, b)
    for k in t_merged:
        assert np.array_equal(t_merged[k].numpy(), np.asarray(j_merged[k]))
        assert np.array_equal(t_local[k].numpy(), np.asarray(j_local[k]))


def test_init_resets_in_the_port_and_not_in_jax():
    """The JAX ``init`` returns early when ``enable_fhe`` is off, so the
    singleton stays encrypted; the port's resets first."""
    on, off = _Args(enable_fhe=True, random_seed=1), _Args(enable_fhe=False)
    jf, tf = JA.FedMLFHE(), TA.FedMLFHE()
    for f in (jf, tf):
        f.init(on)
        assert f.is_fhe_enabled()
        f.init(off)
    assert jf.is_fhe_enabled() and jf.codec is not None
    assert not tf.is_fhe_enabled() and tf.codec is None
