"""The trust stack inside the port's cross-silo federation against the
JAX package's, on the CPU: a server and its silos as threads over
``local``, the port starting from the JAX server's initial weights, every
noise draw the JAX package's own (``tests/torch_trust_parity.py``).

- Through a user ``ServerAggregator`` (a minimal FedAvg) whose hook
  pipeline injects the byzantine attack (random mode, the first silo),
  keeps krum's choice and adds global Gaussian DP: ``lr`` over 5 silos,
  3 rounds (the narrow text transformer's run is
  ``test_torch_trust_cross_silo_text.py``).  Krum must drop the attacked
  silo each round.
- On the default path (no user aggregator): ``norm_diff_clipping`` and
  global DP with its clip before the server optimizer, ``lr`` over 3
  silos.

Each round's global params are held to the JAX run's within ``LR_TOL``."""

import pytest
import torch

from .torch_cross_silo_parity import LR, jax_federation, port_federation
from .torch_trust_parity import (HOOKED, assert_rounds_close, hooked_run,
                                 record_jax_draws, replay_draws,
                                 reset_singletons, silos)

LR_TOL = 1e-6

#: norm-difference clipping + global DP (clip and noise) on the default
#: path
DEFAULT_PATH = dict(enable_defense=True, defense_type="norm_diff_clipping",
                    norm_bound=0.5, enable_dp=True,
                    dp_solution_type="global_dp", dp_epsilon=10.0,
                    dp_sensitivity=0.01, dp_clip_norm=2.0)


@pytest.fixture(autouse=True)
def _isolated():
    """One intra-op thread (small shapes, many federation threads); the
    trust singletons dropped before and after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_singletons()
    yield
    reset_singletons()
    torch.set_num_threads(before)


def _record_default_path(monkeypatch, history):
    """Each round's global params of the default path in both packages."""
    from fedml_tpu.cross_silo.server.fedml_aggregator import \
        FedMLAggregator as J
    from fedml_tpu_torch.cross_silo.server.fedml_aggregator import \
        FedMLAggregator as T

    for pkg, cls in (("jax", J), ("port", T)):
        real = cls.aggregate

        def aggregate(self, _real=real, _pkg=pkg):
            out = _real(self)
            history[_pkg].append(out)
            return out

        monkeypatch.setattr(cls, "aggregate", aggregate)


def test_lr_attack_krum_and_global_dp_through_the_user_hooks(monkeypatch):
    cfg = silos(LR, 5, train_size=400, **HOOKED)
    hist, pt, kept = hooked_run(monkeypatch, cfg, "lr_hooks")
    assert len(kept) == 3 and all(k and 0 not in k for k in kept), kept
    assert_rounds_close(hist["port"], hist["jax"], pt["model"], LR_TOL)


def test_lr_norm_diff_clipping_and_dp_on_the_default_path(monkeypatch):
    cfg = silos(LR, 3, train_size=240, **DEFAULT_PATH)
    hist = {"jax": [], "port": []}
    _record_default_path(monkeypatch, hist)
    draws = record_jax_draws(monkeypatch)
    jx = jax_federation(cfg, "local", "tj_default")
    reset_singletons()
    replay_draws(monkeypatch, draws)
    pt = port_federation(cfg, "local", "tp_default", init=jx["init"])
    assert not any(draws.values()), "JAX drew noise the port did not"
    assert_rounds_close(hist["port"], hist["jax"], pt["model"], LR_TOL)
