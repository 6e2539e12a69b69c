"""Federated round algebra (port of ``fedml_tpu.core.federated``): the
``client_map`` primitive, the stacked reducer and the :class:`RoundProgram`
that composes them.  A round reads ``client_map -> weighted average ->
server update``.

Only the FedAvg family (``fedavg``, ``fedavg_seq``) runs: its round needs
no aggregate beyond the weighted params average.  The JAX package's
``AlgorithmSpec`` registry, which describes the other algorithms' extra
aggregates (SCAFFOLD's Δc, FedNova's τ, ...), comes with those algorithms;
until then they are refused by name.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import torch

from . import tree as tree_util

#: algorithms of the JAX package's zoo that the port does not run yet
UNPORTED_ALGORITHMS = ("fedprox", "fedopt", "fedopt_seq", "feddyn",
                       "scaffold", "fednova", "mime", "fedsgd", "fedbuff",
                       "qfedavg")


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def client_map(fn: Callable, mode: str = "vmap") -> Callable:
    """Map a pure per-client fn over cohort-stacked inputs (leading client
    axis; ``None`` arguments are shared).  ``vmap`` batches the clients
    through ``torch.func.vmap``; ``scan`` runs them one after another and
    stacks their outputs."""
    if mode not in ("vmap", "scan"):
        raise ValueError(f"client_map mode must be 'vmap'|'scan', got {mode!r}")

    def mapped(*args):
        if mode == "vmap":
            dims = tuple(None if a is None else 0 for a in args)
            return torch.func.vmap(fn, in_dims=dims,
                                   randomness="different")(*args)
        n = _lead(next(a for a in args if a is not None))
        outs = [fn(*(_index(a, i) for a in args)) for i in range(n)]
        return _stack(outs)

    return mapped


def _lead(a) -> int:
    if isinstance(a, tuple):
        return _lead(a[0])
    if isinstance(a, dict):
        return _lead(next(iter(a.values())))
    return a.shape[0]


def _index(a, i):
    if a is None:
        return None
    if isinstance(a, tuple):
        return tuple(x[i] for x in a)
    if isinstance(a, dict):
        return {k: v[i] for k, v in a.items()}
    return a[i]


def _stack(outs):
    first = outs[0]
    if isinstance(first, tuple):
        return tuple(_stack([o[j] for o in outs]) for j in range(len(first)))
    if isinstance(first, dict):
        return tree_util.tree_stack(outs)
    return torch.stack(outs)


class StackedReducer:
    """sp engine: the cohort is one stacked tree on this device."""

    def wavg(self, stacked, w):
        return tree_util.stacked_weighted_average(stacked, w)

    def sum_scalar(self, vec):
        return torch.sum(vec)


# --------------------------------------------------------------------------
# algorithms
# --------------------------------------------------------------------------

#: the FedAvg family, the only algorithms the port runs
PORTED_ALGORITHMS = ("fedavg", "fedavg_seq")


def check_algorithm(name: str) -> str:
    """Lower-cased ``name`` if the port runs it; raises otherwise, naming
    the algorithm."""
    name = name.lower()
    if name in UNPORTED_ALGORITHMS:
        raise NotImplementedError(
            f"federated_optimizer {name!r} is not ported yet (the port runs "
            f"{list(PORTED_ALGORITHMS)})")
    if name not in PORTED_ALGORITHMS:
        raise ValueError(f"unknown federated_optimizer {name!r} "
                         f"(the port runs {list(PORTED_ALGORITHMS)})")
    return name


def build_aggregates(red, outs, w) -> Dict[str, Any]:
    """The FedAvg round's cross-client reductions with the engine's
    reducer: the number of real (nonzero-weight) clients and the weighted
    params average."""
    return {"n_sampled": red.sum_scalar((w > 0).to(torch.float32)),
            "avg_params": red.wavg(outs.params, w)}


@dataclass
class RoundProgram:
    """One federated round composed from the primitives::

        new_state, outs, agg = program(state, x, y, mask, weights, drop)

    ``local_train(global_params, xb, yb, mask, drop)`` is the per-client
    body (:meth:`LocalTrainer.make_local_train`); ``drop`` holds the
    cohort's dropout keep-masks (leading client axis) or is ``None``."""
    local_train: Callable
    server_opt: Any
    mode: str = "vmap"
    reducer: Any = field(default_factory=StackedReducer)

    def run_clients(self, state, x, y, mask, drop):
        from ..ml.trainer.local_trainer import ClientOut
        g = state.global_params
        fn = lambda xb, yb, mb, db: self.local_train(g, xb, yb, mb, db)
        return ClientOut(*client_map(fn, self.mode)(x, y, mask, drop))

    def __call__(self, state, x, y, mask, weights, drop=None):
        outs = self.run_clients(state, x, y, mask, drop)
        agg = build_aggregates(self.reducer, outs, weights)
        return self.server_opt.update_from_aggregates(state, agg), outs, agg
