"""The trust stack inside the port's cross-silo federation of a narrow
text transformer (dim 32, one layer; the kernels' plain versions on the
CPU) against the JAX package's: 4 silos, 3 rounds, through a user FedAvg
``ServerAggregator`` whose hooks inject the byzantine attack (random
mode, the first silo), keep krum's choice and add global Gaussian DP,
every noise draw the JAX package's own.  Krum must drop the attacked silo
each round, and each round's global params lie within ``TEXT_TOL`` of the
JAX run's.  A file of its own: the JAX silos' first compiles of the text
pass take most of its time."""

import pytest
import torch

from .torch_cross_silo_parity import TEXT
from .torch_trust_parity import (HOOKED, assert_rounds_close, hooked_run,
                                 reset_singletons, silos)

TEXT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _isolated():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_singletons()
    yield
    reset_singletons()
    torch.set_num_threads(before)


def test_text_attack_krum_and_global_dp_through_the_user_hooks(
        monkeypatch):
    cfg = silos(TEXT, 4, **HOOKED)
    hist, pt, kept = hooked_run(monkeypatch, cfg, "text_hooks")
    assert len(kept) == 3 and all(k and 0 not in k for k in kept), kept
    assert_rounds_close(hist["port"], hist["jax"], pt["model"], TEXT_TOL)
