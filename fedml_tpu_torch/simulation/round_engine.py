"""The federated round as one function of the cohort tensors (port of
``fedml_tpu.simulation.round_engine``, fp32 branch)::

    x:(C, S, B, ...)  y:(C, S, B)  mask:(C, S)  weights:(C,)

- ``scan`` mode: clients run one after another;
- ``vmap`` mode: clients run batched through ``torch.func.vmap``.

The round is ``RoundProgram`` of :mod:`..core.federated`: map the
local-SGD body over the cohort from the server params, build the
algorithm's spec-declared aggregates, step the server.  The round's device
randomness (dropout keep-masks for every client, step and example) is drawn
up front from the round's generator, outside any ``vmap``, so ``scan`` and
``vmap`` see the same masks.  Threefry bits are not reproduced (see
``core/rng.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core import federated
from ..ml.aggregator.agg_operator import ServerOptimizer, ServerState
from ..ml.trainer.local_trainer import LocalTrainer


def make_round_fn(trainer: LocalTrainer, server_opt: ServerOptimizer,
                  mode: str = "scan") -> Callable:
    """``round_fn(state, x, y, mask, weights, generator, c_clients=None) ->
    (new_state, metrics, new_client_state)``.  ``c_clients`` holds the
    cohort's per-client state rows (SCAFFOLD/FedDyn; ``None`` otherwise)
    and ``new_client_state`` their updated rows; the stacked client params
    are not returned.  ``metrics`` holds device scalars (``train_loss``:
    the weight-averaged client loss, ``total_steps``: the real steps
    taken), read by the caller only when it logs."""
    program = federated.RoundProgram(server_opt.spec,
                                     trainer.make_local_train(), server_opt,
                                     mode)
    model = trainer.model

    def round_fn(state: ServerState, x, y, mask, weights,
                 generator: torch.Generator, c_clients=None):
        drop = (model.dropout_masks(generator, tuple(x.shape[:3]))
                if model.has_dropout else None)
        new_state, outs, _ = program(state, x, y, mask, weights, drop,
                                     c_clients)
        metrics = {
            "train_loss": torch.sum(outs.loss * weights) / torch.sum(weights),
            "total_steps": torch.sum(outs.num_steps),
        }
        return new_state, metrics, outs.new_client_state

    return round_fn


def make_gather_round_fn(trainer: LocalTrainer, server_opt: ServerOptimizer,
                         train_x: torch.Tensor, train_y: torch.Tensor,
                         mode: str = "vmap") -> Callable:
    """Device-gather variant: the dataset lives on the device once and the
    round takes only the ``(C, S, B)`` index tensor from the host."""
    inner = make_round_fn(trainer, server_opt, mode)

    def round_fn(state: ServerState, idx, mask, weights, generator,
                 c_clients=None):
        idx = idx.to(torch.long)
        return inner(state, train_x[idx], train_y[idx], mask, weights,
                     generator, c_clients)

    return round_fn


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
