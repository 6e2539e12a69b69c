"""Server state and server optimizer (port of
``fedml_tpu.ml.aggregator.agg_operator``): the server-side state the zoo's
algorithms keep (FedOpt's optimizer moments, SCAFFOLD's c_server, FedDyn's
h, Mime's momentum) and each algorithm's transition from the round's
aggregates, with the population's swept hyperparameters (``hp``) and the
exact merge of cohort-bucket partials.  Not ported: the mesh engine's
scatter-mode layout (``init_sharded``, ``update_shard``), the silo partial
reducer and the quantized-collective fields.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Any, Optional

from ...core import federated
from ...core import tree as tree_util
from ...core.state import ClientOptimizer


@dataclasses.dataclass
class ServerState:
    """Server-side state.  The fields beyond the round counter and the
    global params are ``None`` unless the algorithm keeps them; each
    mirrors the params' ``{name: tensor}`` dict (``opt_state`` is the
    server optimizer's state dict)."""
    round_idx: int
    global_params: Any
    opt_state: Any = None        # FedOpt server optimizer state
    c_server: Any = None         # SCAFFOLD
    h: Any = None                # FedDyn
    momentum: Any = None         # Mime

    def replace(self, **changes) -> "ServerState":
        return dataclasses.replace(self, **changes)


class ServerOptimizer:
    """Stage 1 (the round's aggregates) is declared per algorithm by its
    :class:`~fedml_tpu_torch.core.federated.AlgorithmSpec` and built by
    :func:`~fedml_tpu_torch.core.federated.build_aggregates`; stage 2 is
    :meth:`update_from_aggregates`.  ``algorithm`` defaults to
    ``args.federated_optimizer``."""

    def __init__(self, args, algorithm=None):
        self.args = args
        self.algorithm = federated.check_algorithm(
            algorithm or str(getattr(args, "federated_optimizer", "FedAvg")))
        self.spec = federated.get_spec(self.algorithm)
        self.server_lr = float(getattr(args, "server_lr", 1.0))
        self.server_momentum = float(getattr(args, "server_momentum", 0.9))
        self.feddyn_alpha = float(getattr(args, "feddyn_alpha", 0.01))
        self.total_clients = int(getattr(args, "client_num_in_total", 10))
        # q-FedAvg: fairness exponent and the Lipschitz-estimate lr its Δ/h
        # terms are scaled by
        self.qfed_q = float(getattr(args, "qfed_q", 1.0))
        self.qfed_lr = float(getattr(args, "qfed_lr", 0.0)
                             or getattr(args, "learning_rate", 0.03))
        # FedOpt's server optimizer: optax.sgd(server_lr,
        # momentum=server_momentum) or optax.adam(server_lr,
        # b1=server_momentum, b2=0.99) in the JAX package
        self.server_tx = None
        if self.algorithm in ("fedopt", "fedopt_seq"):
            name = str(getattr(args, "server_optimizer", "adam")).lower()
            if name == "sgd":
                self.server_tx = ClientOptimizer(
                    "sgd", self.server_lr, momentum=self.server_momentum)
            else:
                self.server_tx = ClientOptimizer(
                    "adam", self.server_lr, b1=self.server_momentum, b2=0.99)

    def init(self, params) -> ServerState:
        st = ServerState(round_idx=0, global_params=params)
        if self.server_tx is not None:
            st = st.replace(opt_state=self.server_tx.init(params))
        if self.algorithm == "scaffold":
            st = st.replace(c_server=tree_util.tree_zeros_like(params))
        if self.algorithm == "feddyn":
            st = st.replace(h=tree_util.tree_zeros_like(params))
        if self.algorithm == "mime":
            st = st.replace(momentum=tree_util.tree_zeros_like(params))
        return st

    def compute_aggregates(self, state: ServerState, client_params_stacked,
                           weights, aux: Optional[dict] = None) -> dict:
        """Stage 1 from stacked client params and ``aux`` (stacked over
        clients): "delta_c" (SCAFFOLD), "tau" + "grad_sum" (FedNova),
        "grad_sum" (Mime, FedSGD), "loss" (q-FedAvg)."""
        aux = aux or {}
        outs = types.SimpleNamespace(
            params=client_params_stacked, delta_c=aux.get("delta_c"),
            tau=aux.get("tau"), grad_sum=aux.get("grad_sum"),
            loss=aux.get("loss"))
        return federated.build_aggregates(self.spec,
                                          federated.StackedReducer(), self,
                                          state, outs, weights)

    def merge_aggregates(self, aggs, total_ws) -> dict:
        """Combine per-bucket aggregates (``round_engine.
        make_bucket_agg_fn``) into one cohort aggregate.  Every entry is a
        weighted average, so the merge is the weight-weighted average of
        bucket averages: exact up to float reassociation.  Only the
        stateless weighted-average family (``round_engine.BUCKETABLE_ALGS``)
        reaches it, so there are no auxiliary keys to combine."""
        tw = sum(total_ws)
        avg = {k: sum(w * a["avg_params"][k] for w, a in zip(total_ws, aggs))
               / tw for k in aggs[0]["avg_params"]}
        return {"avg_params": avg,
                "n_sampled": sum(a["n_sampled"] for a in aggs)}

    def update_from_aggregates(self, state: ServerState, agg: dict,
                               hp=None) -> ServerState:
        """Stage 2.  ``hp`` (:class:`~fedml_tpu_torch.core.federated.
        HParams`) overrides the static server hyperparameters with a
        population member's; ``None`` keeps the constants."""
        alg = self.algorithm
        nxt = state.round_idx + 1

        if self.spec.update is not None:
            # registered spec (q-FedAvg): one pure elementwise transition
            new_params, fields = self.spec.update(state.global_params, agg,
                                                  hp, self)
            return state.replace(round_idx=nxt, global_params=new_params,
                                 **fields)
        avg = agg["avg_params"]

        if alg in ("fedopt", "fedopt_seq"):
            # pseudo-gradient = global − avg(client) through the server
            # optimizer
            pseudo_grad = tree_util.tree_sub(state.global_params, avg)
            updates, new_opt = self.server_tx.update(
                pseudo_grad, state.opt_state, state.global_params)
            ratio = federated.lr_ratio(hp, "server_lr", self.server_lr)
            if ratio is not None:
                updates = tree_util.tree_scale(updates, ratio)
            new_params = tree_util.tree_add(state.global_params, updates)
            return state.replace(round_idx=nxt, global_params=new_params,
                                 opt_state=new_opt)

        if alg == "scaffold":
            # x ← x + lr_g·(avg − x);  c ← c + (|S|/N)·mean(Δc)
            lr = federated.resolve(hp, "server_lr", self.server_lr)
            new_params = tree_util.tree_axpy(
                lr, tree_util.tree_sub(avg, state.global_params),
                state.global_params)
            frac = agg["n_sampled"] / self.total_clients
            new_c = tree_util.tree_axpy(frac, agg["mean_delta_c"],
                                        state.c_server)
            return state.replace(round_idx=nxt, global_params=new_params,
                                 c_server=new_c)

        if alg == "fednova":
            # normalised averaging: x ← x − τ_eff · Σ p_i d_i
            new_params = tree_util.tree_axpy(
                -agg["tau_eff"], agg["nova_d"], state.global_params)
            return state.replace(round_idx=nxt, global_params=new_params)

        if alg == "feddyn":
            # h ← h − α·(avg − x)·|S|/N ; x ← avg − h/α
            alpha = federated.resolve(hp, "feddyn_alpha", self.feddyn_alpha)
            frac = agg["n_sampled"] / self.total_clients
            diff = tree_util.tree_sub(avg, state.global_params)
            new_h = tree_util.tree_axpy(-alpha * frac, diff, state.h)
            new_params = tree_util.tree_axpy(-1.0 / alpha, new_h, avg)
            return state.replace(round_idx=nxt, global_params=new_params,
                                 h=new_h)

        if alg == "mime":
            # momentum ← β·momentum + (1−β)·avg_grad ; params ← avg
            b = self.server_momentum
            new_mom = tree_util.tree_map(lambda m, g: b * m + (1 - b) * g,
                                         state.momentum, agg["avg_grad"])
            return state.replace(round_idx=nxt, global_params=avg,
                                 momentum=new_mom)

        if alg == "fedsgd":
            lr = federated.resolve(hp, "server_lr", self.server_lr)
            new_params = tree_util.tree_axpy(-lr, agg["avg_grad"],
                                             state.global_params)
            return state.replace(round_idx=nxt, global_params=new_params)

        # FedAvg / FedAvg_seq / FedProx: params ← weighted average
        return state.replace(round_idx=nxt, global_params=avg)
