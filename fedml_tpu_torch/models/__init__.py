from .base import TorchModel  # noqa: F401
from .model_hub import create  # noqa: F401
