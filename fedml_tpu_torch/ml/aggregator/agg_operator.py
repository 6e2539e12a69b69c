"""Server state and server optimizer (port of
``fedml_tpu.ml.aggregator.agg_operator``) on the FedAvg branch: the new
global params are the round's weighted average of the client params.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ...core import federated


@dataclasses.dataclass
class ServerState:
    """Server-side state; the FedAvg family keeps only the round counter
    and the global params (the JAX package's optimizer moments, control
    variates and residuals belong to algorithms not ported yet)."""
    round_idx: int
    global_params: Any

    def replace(self, **changes) -> "ServerState":
        return dataclasses.replace(self, **changes)


class ServerOptimizer:
    """Stage 1 (the round's aggregates) is built by
    :func:`~fedml_tpu_torch.core.federated.build_aggregates`; stage 2 is
    :meth:`update_from_aggregates`."""

    def __init__(self, args):
        self.args = args
        self.algorithm = federated.check_algorithm(
            str(getattr(args, "federated_optimizer", "FedAvg")))

    def init(self, params) -> ServerState:
        return ServerState(round_idx=0, global_params=params)

    def update_from_aggregates(self, state: ServerState,
                               agg: dict) -> ServerState:
        """FedAvg / FedAvg_seq: params ← weighted average."""
        return state.replace(round_idx=state.round_idx + 1,
                             global_params=agg["avg_params"])
