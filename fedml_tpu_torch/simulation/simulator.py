"""Simulator facades (port of ``fedml_tpu.simulation.simulator``): the
``sp`` backend, dispatching by ``federated_optimizer`` to the hierarchical,
async, buffered-async (``fedbuff``) and decentralized engines, FedNAS,
FedSeg, FedGKT and FedGAN, and to ``FedAvgAPI`` for the synchronous
algorithms of the zoo; and the ``mesh`` backend (the reference's "MPI" and
"NCCL" name it too), dispatching to the ring-gossip mesh engine for
decentralized SGD and to ``MeshFedAvgAPI`` otherwise.  ``num_silos > 1``
on the ``sp`` backend selects the two-tier silo aggregation
(``store/hierarchy.py::HierarchicalSiloAPI``) by topology, not by
optimizer name."""

from __future__ import annotations

from .async_engine import FedBuffAPI
from .sp.async_fedavg import AsyncFedAvgAPI
from .sp.decentralized import DecentralizedFedAPI
from .sp.fedavg_api import FedAvgAPI
from .sp.fedgan import FedGANAPI
from .sp.fedgkt import FedGKTAPI
from .sp.fednas import FedNASAPI
from .sp.fedseg import FedSegAPI
from .sp.hierarchical_fl import HierarchicalFedAvgAPI


class SimulatorSingleProcess:
    def __init__(self, args, device, dataset, model, client_trainer=None,
                 server_aggregator=None):
        if client_trainer is not None or server_aggregator is not None:
            raise NotImplementedError(
                "custom client trainers and server aggregators are not "
                "ported yet")
        mode = str(getattr(args, "sp_client_mode", "vmap"))
        alg = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
        if alg in HierarchicalFedAvgAPI.NAMES:
            self.fl_trainer = HierarchicalFedAvgAPI(args, device, dataset,
                                                    model, client_mode=mode)
        elif alg in AsyncFedAvgAPI.NAMES:
            self.fl_trainer = AsyncFedAvgAPI(args, device, dataset, model,
                                             client_mode=mode)
        elif alg in DecentralizedFedAPI.NAMES:
            self.fl_trainer = DecentralizedFedAPI(args, device, dataset,
                                                  model)
        elif alg == "fednas":
            self.fl_trainer = FedNASAPI(args, dataset, model, device)
        elif alg == "fedseg":
            self.fl_trainer = FedSegAPI(args, dataset, model, device)
        elif alg == "fedgkt":
            self.fl_trainer = FedGKTAPI(args, dataset, device)
        elif alg == "fedgan":
            idxs = [dataset.client_idxs[c] for c in range(dataset.num_clients)]
            self.fl_trainer = FedGANAPI(args, dataset.train_x, idxs,
                                        device=device)
        elif alg in FedBuffAPI.NAMES:
            self.fl_trainer = FedBuffAPI(args, device, dataset, model,
                                         client_mode=mode)
        elif int(getattr(args, "num_silos", 0) or 0) > 1:
            from ..store.hierarchy import HierarchicalSiloAPI
            self.fl_trainer = HierarchicalSiloAPI(args, device, dataset,
                                                  model, client_mode=mode)
        else:
            self.fl_trainer = FedAvgAPI(args, device, dataset, model,
                                        client_mode=mode)

    def run(self):
        return self.fl_trainer.train()


class SimulatorMesh:
    def __init__(self, args, device, dataset, model, client_trainer=None,
                 server_aggregator=None):
        if client_trainer is not None or server_aggregator is not None:
            raise NotImplementedError(
                "custom client trainers and server aggregators are not "
                "ported yet")
        from .mesh.decentralized_mesh import MeshDecentralizedAPI
        from .mesh.engine import MeshFedAvgAPI
        alg = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
        if alg in MeshDecentralizedAPI.NAMES:
            # ring gossip as per-edge send/recv (push_sum's asymmetric W
            # has no ring form: the engine refuses it)
            self.fl_trainer = MeshDecentralizedAPI(args, device, dataset,
                                                   model)
        else:
            self.fl_trainer = MeshFedAvgAPI(args, device, dataset, model)

    def run(self):
        return self.fl_trainer.train()


def create_simulator(args, device, dataset, model, client_trainer=None,
                     server_aggregator=None):
    backend = str(getattr(args, "backend", "sp"))
    if backend == "sp":
        return SimulatorSingleProcess(args, device, dataset, model,
                                      client_trainer, server_aggregator)
    if backend in ("mesh", "MPI", "NCCL"):
        return SimulatorMesh(args, device, dataset, model, client_trainer,
                             server_aggregator)
    raise ValueError(f"unknown simulation backend {backend!r}")
