"""Simulator facades (port of ``fedml_tpu.simulation.simulator``): the
``sp`` backend with the default ``FedAvgAPI`` dispatch.  The mesh backend
(and its reference aliases "MPI"/"NCCL") and the other sp engines are not
ported yet and raise by name."""

from __future__ import annotations

from .sp.fedavg_api import FedAvgAPI

#: sp engines of the JAX package's dispatch that the port does not run yet
_OTHER_SP_ENGINES = ("hierarchicalfl", "hierarchical_fl", "fedbuff",
                     "async_fedavg", "fedasync", "decentralized_fl", "dsgd",
                     "push_sum", "fednas", "fedseg", "fedgkt", "fedgan")


class SimulatorSingleProcess:
    def __init__(self, args, device, dataset, model, client_trainer=None,
                 server_aggregator=None):
        if client_trainer is not None or server_aggregator is not None:
            raise NotImplementedError(
                "custom client trainers and server aggregators are not "
                "ported yet")
        alg = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
        if alg in _OTHER_SP_ENGINES:
            raise NotImplementedError(
                f"the {alg!r} sp engine is not ported yet")
        if int(getattr(args, "num_silos", 0) or 0) > 1:
            raise NotImplementedError(
                "num_silos > 1 (two-tier silo aggregation) is not ported yet")
        self.fl_trainer = FedAvgAPI(
            args, device, dataset, model,
            client_mode=str(getattr(args, "sp_client_mode", "vmap")))

    def run(self):
        return self.fl_trainer.train()


def create_simulator(args, device, dataset, model, client_trainer=None,
                     server_aggregator=None):
    backend = str(getattr(args, "backend", "sp"))
    if backend == "sp":
        return SimulatorSingleProcess(args, device, dataset, model,
                                      client_trainer, server_aggregator)
    if backend in ("mesh", "MPI", "NCCL"):
        raise NotImplementedError(
            f"simulation backend {backend!r} (the mesh engine) is not ported "
            "yet")
    raise ValueError(f"unknown simulation backend {backend!r}")
