"""``fedml_tpu_torch.model`` — alias namespace of ``fedml_tpu.model``."""

from .models import TorchModel, create

__all__ = ["TorchModel", "create"]
