"""Server state and server optimizer (port of
``fedml_tpu.ml.aggregator.agg_operator``): the server-side state the zoo's
algorithms keep (FedOpt's optimizer moments, SCAFFOLD's c_server, FedDyn's
h, Mime's momentum) and each algorithm's transition from the round's
aggregates, with the population's swept hyperparameters (``hp``) and the
exact merge of cohort-bucket partials, and the mesh engine's two layouts:
the replicated one (every aux field mirrors the params dict) and the
scatter one (``init_sharded``: every aux field a flat f32 vector of the
padded flat model, of which each client shard keeps one chunk, and
``update_shard`` transitioning that chunk).  The quantized collectives
add three fields (``ef_num``, ``master_flat``, ``ef_bcast``).  The silo
tier of the two-tier aggregation (:meth:`ServerOptimizer.
compute_partial_aggregates`, combined by ``federated.
combine_partial_aggregates``) serves the cross-silo server.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Any, Optional

import torch

from ...core import federated
from ...core import tree as tree_util
from ...core.flatmodel import FlatSpec
from ...core.state import ClientOptimizer

#: the key a flat vector takes in the dicts the server optimizer works on
#: (scatter layout: ``opt_state`` is ``{"mu/flat", "nu/flat", "count"}``)
FLAT = "flat"


@dataclasses.dataclass
class ServerState:
    """Server-side state.  The fields beyond the round counter and the
    global params are ``None`` unless the algorithm keeps them.  In the
    replicated layout each mirrors the params' ``{name: tensor}`` dict
    (``opt_state`` is the server optimizer's state dict); in the scatter
    layout (:meth:`ServerOptimizer.init_sharded`) each is a flat f32
    vector (``opt_state`` a dict of them)."""
    round_idx: int
    global_params: Any
    opt_state: Any = None        # FedOpt server optimizer state
    c_server: Any = None         # SCAFFOLD
    h: Any = None                # FedDyn
    momentum: Any = None         # Mime
    # -- quantized collectives; all None at collective_precision fp32 ----
    #: error-feedback residual of the quantized merge numerator,
    #: ``(n_shards, flat_len)``: one row per shard
    ef_num: Any = None
    #: fp32 master of the flat params: with a quantized broadcast,
    #: ``global_params`` holds the low-precision copy the clients train
    #: from and the server update transitions this master
    master_flat: Any = None
    #: error-feedback residual of the int8 params broadcast
    ef_bcast: Any = None

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

    def init(self, params, collective_precision: str = "fp32",
             ef_shards: int = 1, quantized_broadcast: bool = True,
             flat: FlatSpec = None) -> ServerState:
        """The replicated-layout state.  A quantized ``collective_precision``
        adds one EF row per shard (``ef_shards``) over the unpadded flat
        view ``flat`` (default: the params in dict order), and, when the
        broadcast is quantized too (the sp engine; not the mesh's
        replicated merge), the fp32 master and at int8 its residual."""
        st = ServerState(round_idx=0, global_params=params)
        if self.server_tx is not None:
            st = st.replace(opt_state=self.server_tx.init(params))
        if self.algorithm == "scaffold":
            st = st.replace(c_server=tree_util.tree_zeros_like(params))
        if self.algorithm == "feddyn":
            st = st.replace(h=tree_util.tree_zeros_like(params))
        if self.algorithm == "mime":
            st = st.replace(momentum=tree_util.tree_zeros_like(params))
        if collective_precision != "fp32":
            vec = (flat or FlatSpec.of(params)).flatten(params)
            st = st.replace(ef_num=torch.zeros((ef_shards, vec.shape[0]),
                                               dtype=torch.float32,
                                               device=vec.device))
            if quantized_broadcast:
                st = st.replace(master_flat=vec)
                if collective_precision == "int8":
                    st = st.replace(ef_bcast=torch.zeros_like(vec))
        return st

    def init_sharded(self, params, n_shards: int, flat: FlatSpec,
                     collective_precision: str = "fp32") -> ServerState:
        """Scatter-layout state (arXiv:2004.13336): every aux field a flat
        f32 vector over ``flat`` (the padded flat view, its length a
        multiple of ``n_shards``), whole here; the mesh layout keeps one
        chunk per shard (``simulation/mesh/layout.py``).
        ``global_params`` stays the params dict the clients train from.
        A quantized precision adds the EF rows (one per shard), the fp32
        master and at int8 the broadcast residual."""
        vec = flat.flatten(params)
        zeros = lambda: torch.zeros_like(vec)
        st = ServerState(round_idx=0, global_params=params)
        if self.server_tx is not None:
            st = st.replace(opt_state=self.server_tx.init({FLAT: vec}))
        if self.algorithm == "scaffold":
            st = st.replace(c_server=zeros())
        if self.algorithm == "feddyn":
            st = st.replace(h=zeros())
        if self.algorithm == "mime":
            st = st.replace(momentum=zeros())
        if collective_precision != "fp32":
            st = st.replace(ef_num=torch.zeros((n_shards, vec.shape[0]),
                                               dtype=torch.float32,
                                               device=vec.device),
                            master_flat=vec)
            if collective_precision == "int8":
                st = st.replace(ef_bcast=zeros())
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

    def compute_partial_aggregates(self, state: ServerState,
                                   client_params_stacked, weights,
                                   aux: Optional[dict] = None) -> dict:
        """Silo tier of the two-tier aggregation: the aggregates of
        :meth:`compute_aggregates` reduced with a ``federated.
        PartialReducer``, every weighted entry an unfinished ``{num, den}``
        pair that ``federated.combine_partial_aggregates`` finishes across
        silos before one :meth:`update_from_aggregates`."""
        aux = aux or {}
        outs = types.SimpleNamespace(
            params=client_params_stacked, delta_c=aux.get("delta_c"),
            tau=aux.get("tau"), grad_sum=aux.get("grad_sum"),
            loss=aux.get("loss"))
        return federated.build_aggregates(self.spec,
                                          federated.PartialReducer(), self,
                                          state, outs, weights)

    def update(self, state: ServerState, client_params_stacked, weights,
               aux: Optional[dict] = None) -> ServerState:
        """One server step over stacked client outputs (the cross-silo
        server's merge): :meth:`compute_aggregates` then
        :meth:`update_from_aggregates`."""
        agg = self.compute_aggregates(state, client_params_stacked, weights,
                                      aux)
        return self.update_from_aggregates(state, agg)

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

    def update_shard(self, state: ServerState, gshard: torch.Tensor,
                     agg: dict, hp=None):
        """Stage 2 on this shard's contiguous flat chunk of the model (the
        scatter layout): ``gshard`` is the current params' chunk, ``agg``
        holds reduce-scattered chunks and all-reduced scalars, and
        ``state``'s aux fields are this shard's chunks.  Every transition
        is elementwise, so :meth:`update_from_aggregates` runs on the
        chunks wrapped as one-leaf ``{FLAT: chunk}`` dicts.  Returns
        ``(new_gshard, replaced_fields)``; the caller all-gathers only
        ``new_gshard``, the aux chunks stay on their shard."""
        wrap = lambda v: None if v is None else {FLAT: v}
        new = self.update_from_aggregates(
            state.replace(global_params={FLAT: gshard},
                          **{f: wrap(getattr(state, f)) for f in _FLAT_AUX}),
            agg_dicts(agg), hp)
        fields = {f: getattr(new, f)[FLAT] for f in _FLAT_AUX
                  if getattr(new, f) is not None}
        if new.opt_state is not None:
            fields["opt_state"] = new.opt_state
        return new.global_params[FLAT], fields


#: the aux fields the scatter layout keeps as one flat chunk a shard
_FLAT_AUX = ("c_server", "h", "momentum")


def agg_dicts(agg: dict) -> dict:
    """A scatter-layout aggregate dict with each flat chunk wrapped as the
    one-leaf dict ``{FLAT: chunk}`` a tree-wise spec transition reads."""
    return {k: {FLAT: v} if isinstance(v, torch.Tensor) and v.dim() >= 1
            else v for k, v in agg.items()}
