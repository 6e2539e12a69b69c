"""Cross-silo server facade (port of ``fedml_tpu.cross_silo.server``).

``Server(args, device, dataset, model, server_aggregator=None)`` keeps the
JAX signature; ``device`` ``None`` means the card (``args.device="cpu"``
or ``device="cpu"`` asks for the CPU).  Not ported, and raising by name
when imported from here: ``AsyncFedMLServerManager`` (the async
cross-silo server).
"""

from __future__ import annotations

from ...core.alg_frame.client_trainer import refuse_trust_stack
from .fedml_aggregator import FedMLAggregator
from .fedml_server_manager import FedMLServerManager


class Server:
    def __init__(self, args, device, dataset, model, server_aggregator=None):
        refuse_trust_stack(args, "cross-silo Server")
        client_num = len(getattr(args, "client_id_list", []) or []) or int(
            getattr(args, "client_num_per_round", 2))
        size = client_num + 1
        backend = str(getattr(args, "backend", "local"))
        if backend in ("sp", "mesh", "MPI", "NCCL"):
            backend = "local"
        self.aggregator = FedMLAggregator(args, model, dataset, client_num,
                                          device=device)
        if server_aggregator is not None:
            self.aggregator.user_aggregator = server_aggregator
        self.server_manager = FedMLServerManager(
            args, self.aggregator, rank=0, size=size, backend=backend)

    def run(self):
        self.server_manager.run()
        return self.aggregator.get_global_model_params()


def __getattr__(name):
    if name == "AsyncFedMLServerManager":
        raise NotImplementedError(
            "AsyncFedMLServerManager (the async cross-silo server) is not "
            "ported")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Server", "FedMLAggregator", "FedMLServerManager"]
