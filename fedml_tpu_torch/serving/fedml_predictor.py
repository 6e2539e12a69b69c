"""FedMLPredictor ABC (port of ``fedml_tpu.serving.fedml_predictor``, a
copy: the module is pure Python)."""

from __future__ import annotations

import abc


class FedMLPredictor(abc.ABC):
    def __init__(self):
        pass

    @abc.abstractmethod
    def predict(self, *args, **kwargs):
        ...

    def ready(self) -> bool:
        return True
