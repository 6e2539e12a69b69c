"""FedMLRunner facade (port of ``fedml_tpu.runner``): builds the simulator
for ``training_type="simulation"``.  The cross-silo and cross-device
runners are not ported yet and raise by name."""

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
        elif t in ("cross_silo", "cross_device"):
            raise NotImplementedError(
                f"training_type {t!r} is not ported yet")
        else:
            raise ValueError(f"unknown training_type {t!r}")

    def run(self):
        return self.runner.run()
