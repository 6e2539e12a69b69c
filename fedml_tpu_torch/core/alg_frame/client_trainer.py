"""ClientTrainer ABC — the client-side half of the user-facing algorithm
frame (port of ``fedml_tpu.core.alg_frame.client_trainer``).

Surface parity: ``train / get_model_params / set_model_params`` plus the
``on_before_local_training`` / ``on_after_local_training`` hook pair
through which the trust plugins are threaded: data poisoning and the FHE
decrypt of the incoming global model before the local pass; local DP
noise, model poisoning and the FHE encrypt of the update after it.
"params" is the port's ``{name: tensor}`` dict.

What differs from the JAX module: upload compression is not ported; an
``args`` that enables it raises ``NotImplementedError`` naming the flag
(:func:`refuse_trust_stack`) when a trainer, an aggregator or a
cross-silo ``Server``/``Client`` is built.
"""

from __future__ import annotations

import abc
from typing import Any

from ..dp.fedml_differential_privacy import FedMLDifferentialPrivacy
from ..fhe.fhe_agg import FedMLFHE
from ..security.defense.common import use_layout
from ..security.fedml_attacker import FedMLAttacker

#: the flags of the JAX package's trust stack and upload compression that
#: the port does not implement
TRUST_STACK_FLAGS = {
    "enable_compression": "upload compression (core/compression/)",
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
        use_layout(model)
        FedMLAttacker.get_instance().init(args)
        FedMLDifferentialPrivacy.get_instance().init(args)
        FedMLFHE.get_instance().init(args)

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
        """Data poisoning (red-team) of the local data, then the FHE decrypt
        of the incoming global model."""
        atk = FedMLAttacker.get_instance()
        if atk.is_data_poisoning_attack() and atk.is_to_poison_data():
            train_data = atk.poison_data(train_data)
        if FedMLFHE.get_instance().is_fhe_enabled():
            self.set_model_params(
                FedMLFHE.get_instance().fhe_dec("local", self.get_model_params()))
        return train_data

    @abc.abstractmethod
    def train(self, train_data, device, args):
        ...

    def on_after_local_training(self, train_data, device, args):
        """Local DP noise, model poisoning, then the FHE encrypt of the
        trained params."""
        dp = FedMLDifferentialPrivacy.get_instance()
        if dp.is_local_dp_enabled():
            self.set_model_params(dp.add_local_noise(self.get_model_params()))
        atk = FedMLAttacker.get_instance()
        if atk.is_model_attack():
            self.set_model_params(atk.attack_model(
                self.get_model_params(), self.local_sample_number))
        if FedMLFHE.get_instance().is_fhe_enabled():
            self.set_model_params(
                FedMLFHE.get_instance().fhe_enc("local", self.get_model_params()))

    def test(self, test_data, device, args) -> Any:
        return None
