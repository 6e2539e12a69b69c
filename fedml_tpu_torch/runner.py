"""FedMLRunner facade (port of ``fedml_tpu.runner``): builds the simulator
for ``training_type="simulation"`` and the cross-silo ``Server`` or
``Client`` (``args.role``) for ``training_type="cross_silo"``.  The
cross-device runner is not ported and raises by name."""

from __future__ import annotations


class FedMLRunner:
    def __init__(self, args, device, dataset, model, client_trainer=None,
                 server_aggregator=None):
        self.args = args
        t = str(getattr(args, "training_type", "simulation"))
        if t == "simulation":
            from .simulation.simulator import create_simulator
            self.runner = create_simulator(args, device, dataset, model,
                                           client_trainer, server_aggregator)
        elif t == "cross_silo":
            self.runner = self._init_cross_silo_runner(
                args, device, dataset, model, client_trainer,
                server_aggregator)
        elif t == "cross_device":
            raise NotImplementedError(
                "training_type 'cross_device' (the cross-device server) is "
                "not ported")
        else:
            raise ValueError(f"unknown training_type {t!r}")

    def _init_cross_silo_runner(self, args, device, dataset, model,
                                client_trainer, server_aggregator):
        role = str(getattr(args, "role", "client"))
        if role == "server":
            from .cross_silo.server import Server
            return Server(args, device, dataset, model, server_aggregator)
        from .cross_silo.client import Client
        return Client(args, device, dataset, model, client_trainer)

    def run(self):
        return self.runner.run()
