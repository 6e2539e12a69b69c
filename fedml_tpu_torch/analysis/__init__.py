"""Runtime analysis of the port (the counterpart of the JAX package's
``fedml_tpu.analysis.runtime``): :class:`~.runtime.TorchRuntimeAudit`."""

from .runtime import TorchRuntimeAudit  # noqa: F401

__all__ = ["TorchRuntimeAudit"]
