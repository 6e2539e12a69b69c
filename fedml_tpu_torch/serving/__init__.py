"""Serving (port of ``fedml_tpu.serving``): KV-cached ``generate`` with the
prefix caches, the continuous-batching engine (dense or paged KV, chunked
prefill), speculative decode (``speculative_generate`` and the
speculative batching engine), the multi-tenant adapter bank with its cache
mode over an adapter store, int8 weight-only trees on every decode path,
the OpenAI-compatible server, and the predictor ABC with its HTTP
inference runner.

Not ported, each refused by name: the federated serving client and server
(``FedMLModelServingClient``/``FedMLModelServingServer``, with
``cross_silo/``), the StableHLO artifact export (``save_model_artifact``,
``load_model_artifact``) and the observability hooks (``metrics_port``,
``slo_rules``).
"""

from .adapter_store import AdapterStore
from .adapters import AdapterMissError, AdapterRegistry, BankFullError
from .batching import (ContinuousBatchingEngine, PagedKVUnsupportedError,
                       SpeculativeBatchingEngine)
from .speculative import speculative_generate
from .fedml_inference_runner import FedMLInferenceRunner
from .fedml_predictor import FedMLPredictor
from .templates.openai_compat import OpenAICompatServer, generate


def _refuse(name: str, what: str):
    raise NotImplementedError(f"{name}: {what} is not ported")


class FedMLModelServingServer:
    """The federated serving server state machine: not ported."""

    def __init__(self, *args, **kwargs):
        _refuse("FedMLModelServingServer",
                "the federated serving server (cross_silo)")


class FedMLModelServingClient:
    """The federated serving client state machine: not ported."""

    def __init__(self, *args, **kwargs):
        _refuse("FedMLModelServingClient",
                "the federated serving client (cross_silo)")


def save_model_artifact(*args, **kwargs):
    """StableHLO model artifact export: not ported."""
    _refuse("save_model_artifact (export)", "the StableHLO artifact export")


def load_model_artifact(*args, **kwargs):
    """StableHLO model artifact import: not ported."""
    _refuse("load_model_artifact (export)", "the StableHLO artifact export")


__all__ = ["AdapterMissError", "AdapterRegistry", "AdapterStore",
           "BankFullError", "ContinuousBatchingEngine",
           "FedMLInferenceRunner", "FedMLModelServingClient",
           "FedMLModelServingServer", "FedMLPredictor", "OpenAICompatServer",
           "PagedKVUnsupportedError", "SpeculativeBatchingEngine",
           "generate", "load_model_artifact", "save_model_artifact",
           "speculative_generate"]
