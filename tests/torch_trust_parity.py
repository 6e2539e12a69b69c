"""Shared helpers of the trust-stack parity tests
(``test_torch_trust_*.py``): record the JAX package's noise draws and
replay them through the port's one draw function
(``fedml_tpu_torch.core.noise.draw``), so every other step of a noising
attack, defense or DP frame is held to the JAX arithmetic; and run a
cross-silo federation with the trust stack in both packages.

The JAX modules draw through their own ``jax`` global
(``jax.random.normal``/``laplace``); :func:`record_jax_draws` swaps that
global for a proxy that logs each draw under the module's noise purpose,
so draws made elsewhere in the process (a client thread's jit, a model
init) are never picked up."""

import collections
import importlib

import jax
import numpy as np
import torch

from fedml_tpu_torch.core import tree as tree_util
from fedml_tpu_torch.models.convert import from_flax

from .torch_cross_silo_parity import jax_federation, port_federation

#: JAX module → the port's noise purpose of its draws
JAX_DRAW_SITES = {
    "fedml_tpu.core.dp.mechanisms": "dp",
    "fedml_tpu.core.security.attack.byzantine_attack": "byzantine",
    "fedml_tpu.core.security.attack.lazy_worker_attack": "lazy_worker",
    "fedml_tpu.core.security.defense.clipping": None,   # weak_dp, crfl
    "fedml_tpu.core.security.attack.gradient_inversion": "dlg",
}


class _Random:
    def __init__(self, log, purpose):
        self._log, self._purpose = log, purpose

    def __getattr__(self, name):
        return getattr(jax.random, name)

    def _record(self, fn, *a, **kw):
        out = fn(*a, **kw)
        purpose = self._purpose
        if purpose is None:   # clipping.py: the defense class is the caller
            import sys
            caller = sys._getframe(2).f_locals.get("self")
            purpose = {"WeakDPDefense": "weak_dp",
                       "CRFLDefense": "crfl"}[type(caller).__name__]
        self._log[purpose].append(np.asarray(out))
        return out

    def normal(self, *a, **kw):
        return self._record(jax.random.normal, *a, **kw)

    def laplace(self, *a, **kw):
        return self._record(jax.random.laplace, *a, **kw)


class _Jax:
    def __init__(self, log, purpose):
        self.random = _Random(log, purpose)

    def __getattr__(self, name):
        return getattr(jax, name)


def record_jax_draws(monkeypatch):
    """Log every noise draw of the JAX trust stack: ``{purpose: [array,
    ...]}`` in draw order."""
    log = collections.defaultdict(list)
    for mod, purpose in JAX_DRAW_SITES.items():
        m = importlib.import_module(mod)
        monkeypatch.setattr(m, "jax", _Jax(log, purpose))
    return log


def replay_draws(monkeypatch, log):
    """Make the port's :func:`~fedml_tpu_torch.core.noise.draw` return the
    logged JAX draws of each purpose in order (shapes checked); returns
    the log, emptied as the port draws."""
    from fedml_tpu_torch.core import noise

    def draw(source, shape, device, kind="normal", dtype=torch.float32):
        queue = log[source.purpose]
        assert queue, f"the port drew more {source.purpose} noise than JAX"
        z = queue.pop(0)
        assert tuple(z.shape) == tuple(shape), (source.purpose, z.shape,
                                                shape)
        return torch.tensor(np.asarray(z, np.float32), device=device,
                            dtype=dtype)

    monkeypatch.setattr(noise, "draw", draw)
    return log


def reset_singletons():
    """Drop both packages' trust singletons (process state across
    tests)."""
    from fedml_tpu.core.dp.fedml_differential_privacy import \
        FedMLDifferentialPrivacy as JDP
    from fedml_tpu.core.security.fedml_attacker import FedMLAttacker as JA
    from fedml_tpu.core.security.fedml_defender import FedMLDefender as JD
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import \
        FedMLDifferentialPrivacy as TDP
    from fedml_tpu_torch.core.security.fedml_attacker import \
        FedMLAttacker as TA
    from fedml_tpu_torch.core.security.fedml_defender import \
        FedMLDefender as TD
    for cls in (JDP, JA, JD, TDP, TA, TD):
        cls._instance = None


# -- cross-silo federations with the trust stack ---------------------------

#: attack + krum + global DP, as the hook pipeline's flags
HOOKED = dict(enable_attack=True, attack_type="byzantine",
              attack_mode="random", byzantine_client_num=1,
              enable_defense=True, defense_type="krum", enable_dp=True,
              dp_solution_type="global_dp", dp_mechanism_type="gaussian",
              dp_epsilon=10.0, dp_sensitivity=0.01)


def silos(cfg, n, **over):
    """``cfg`` over ``n`` silos (all of them every round), 3 rounds."""
    ids = list(range(1, n + 1))
    return dict(cfg, client_num_in_total=n, client_num_per_round=n,
                client_id_list=ids, comm_round=3, **over)


def fedavg_aggregator(pkg, history):
    """A minimal FedAvg ``ServerAggregator`` of ``pkg`` that records each
    round's global params (after the hooks)."""
    if pkg == "jax":
        from fedml_tpu.core import tree as tu
        from fedml_tpu.core.alg_frame.server_aggregator import \
            ServerAggregator
    else:
        from fedml_tpu_torch.core.alg_frame.server_aggregator import \
            ServerAggregator
        tu = tree_util

    class FedAvg(ServerAggregator):
        def get_model_params(self):
            return self._params

        def set_model_params(self, p):
            self._params = p

        def aggregate(self, raw_list):
            return tu.weighted_average([p for _, p in raw_list],
                                       [n for n, _ in raw_list])

        def on_after_aggregation(self, agg):
            out = super().on_after_aggregation(agg)
            history.append(out)
            return out

        def test(self, test_data, device, args):
            return None

    return FedAvg


def assert_rounds_close(port_hist, jax_hist, model, tol):
    """Each of the 3 rounds' global params of the port within ``tol`` of
    the JAX run's (carried into the port's names and layout)."""
    assert len(port_hist) == len(jax_hist) == 3
    for r, (got, want) in enumerate(zip(port_hist, jax_hist)):
        ref = from_flax(jax.device_get(want), model, device="cpu")
        assert list(got) == list(ref)
        for k in got:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       ref[k].numpy(), rtol=0, atol=tol,
                                       err_msg=f"round {r} {k}")


def hooked_run(monkeypatch, cfg, tag):
    """The federation through a user FedAvg aggregator in both packages,
    the JAX draws replayed in the port: each package's round history, the
    port's run and krum's selection in each port round."""
    hist = {"jax": [], "port": []}
    draws = record_jax_draws(monkeypatch)
    jx = jax_federation(cfg, "local", f"tj_{tag}",
                        agg_factory=lambda m, a: fedavg_aggregator(
                            "jax", hist["jax"])(m, a))
    reset_singletons()
    replay_draws(monkeypatch, draws)
    kept = []
    from fedml_tpu_torch.core.security.fedml_defender import FedMLDefender

    def agg_factory(m, a):
        agg = fedavg_aggregator("port", hist["port"])(m, a)
        real = agg.on_before_aggregation

        def before(raw):
            out = real(raw)
            kept.append(list(FedMLDefender.get_instance()
                             .defender.last_selected))
            return out

        agg.on_before_aggregation = before
        return agg

    pt = port_federation(cfg, "local", f"tp_{tag}", init=jx["init"],
                         agg_factory=agg_factory)
    assert not any(draws.values()), "JAX drew noise the port did not"
    return hist, pt, kept
