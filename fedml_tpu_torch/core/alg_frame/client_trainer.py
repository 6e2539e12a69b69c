"""ClientTrainer ABC — the client-side half of the user-facing algorithm
frame (port of ``fedml_tpu.core.alg_frame.client_trainer``).

Surface parity: ``train / get_model_params / set_model_params`` plus the
``on_before_local_training`` / ``on_after_local_training`` hook pair.
"params" is the port's ``{name: tensor}`` dict.

What differs from the JAX module: the trust plugins the JAX hooks thread
through (the red-team attacker, differential privacy, FHE) and the upload
compression and contribution assessment beside them are not ported.  The
hooks run as the JAX package runs them with every plugin off (identity),
and an ``args`` that enables one raises ``NotImplementedError`` naming
the flag (:func:`refuse_trust_stack`) when a trainer, an aggregator or a
cross-silo ``Server``/``Client`` is built.
"""

from __future__ import annotations

import abc
from typing import Any

#: the flags of the JAX package's trust stack and upload compression, none
#: of which the port implements
TRUST_STACK_FLAGS = {
    "enable_defense": "the robust-aggregation defenses (core/security/)",
    "enable_dp": "differential privacy (core/dp/)",
    "enable_attack": "the red-team attacker (core/security/)",
    "enable_fhe": "homomorphic encryption (core/fhe/)",
    "enable_compression": "upload compression (core/compression/)",
    "enable_contribution": "contribution assessment (core/contribution/)",
}


def refuse_trust_stack(args, where: str) -> None:
    """Raise ``NotImplementedError`` naming the first trust-stack flag
    ``args`` turns on."""
    for flag, what in TRUST_STACK_FLAGS.items():
        if bool(getattr(args, flag, False)):
            raise NotImplementedError(
                f"{where}: {flag}=True asks for {what}, which is not ported")


class ClientTrainer(abc.ABC):
    def __init__(self, model, args):
        refuse_trust_stack(args, type(self).__name__)
        self.model = model
        self.id = 0
        self.args = args
        self.local_sample_number = 0
        self.rid = 0
        self.template_model_params = None

    def set_id(self, trainer_id):
        self.id = trainer_id

    def is_main_process(self) -> bool:
        return True

    @abc.abstractmethod
    def get_model_params(self):
        ...

    @abc.abstractmethod
    def set_model_params(self, model_parameters):
        ...

    def on_before_local_training(self, train_data, device, args):
        """Data poisoning and FHE decrypt in the JAX package; with both off,
        the data passes unchanged."""
        return train_data

    @abc.abstractmethod
    def train(self, train_data, device, args):
        ...

    def on_after_local_training(self, train_data, device, args):
        """Local DP noise, model poisoning and FHE encrypt in the JAX
        package; with all three off, nothing happens."""

    def test(self, test_data, device, args) -> Any:
        return None
