"""Cross-silo client facade (port of ``fedml_tpu.cross_silo.client``).

``Client(args, device, dataset, model, client_trainer=None)`` keeps the
JAX signature; ``device`` ``None`` means the card.  A silo is one process
(or thread) on one device.  Not ported, and raising ``NotImplementedError``
by name: ``scenario="hierarchical"`` and slave ranks
(``proc_rank_in_silo > 0``) — the JAX package's intra-silo data
parallelism — with their ``ClientSlaveManager`` and ``ProcessGroupManager``.
"""

from __future__ import annotations

from ...core.alg_frame.client_trainer import refuse_trust_stack
from .fedml_client_master_manager import ClientMasterManager, TrainerDistAdapter

_HIERARCHICAL = ("the hierarchical cross-silo scenario (intra-silo data "
                 "parallelism over slave ranks) is not ported")


class Client:
    def __init__(self, args, device, dataset, model, client_trainer=None):
        refuse_trust_stack(args, "cross-silo Client")
        if str(getattr(args, "scenario", "horizontal")) == "hierarchical":
            raise NotImplementedError(f"scenario='hierarchical': "
                                      f"{_HIERARCHICAL}")
        if int(getattr(args, "proc_rank_in_silo", 0)) > 0:
            raise NotImplementedError(f"proc_rank_in_silo > 0 (a slave "
                                      f"rank): {_HIERARCHICAL}")
        client_num = len(getattr(args, "client_id_list", []) or []) or int(
            getattr(args, "client_num_per_round", 2))
        size = client_num + 1
        backend = str(getattr(args, "backend", "local"))
        if backend in ("sp", "mesh", "MPI", "NCCL"):
            backend = "local"
        adapter = TrainerDistAdapter(args, model, dataset, device=device)
        if client_trainer is not None:
            adapter.user_trainer = client_trainer
        rank = int(getattr(args, "rank", 1))
        self.client_manager = ClientMasterManager(
            args, adapter, rank=rank, size=size, backend=backend)

    def run(self):
        self.client_manager.run()


def __getattr__(name):
    if name in ("ClientSlaveManager", "ProcessGroupManager"):
        raise NotImplementedError(f"{name}: {_HIERARCHICAL}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Client", "ClientMasterManager", "TrainerDistAdapter"]
