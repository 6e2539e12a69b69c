"""Mesh-sharded federated simulation (port of
``fedml_tpu.simulation.mesh.engine``) on ``torch.distributed``.

The JAX package runs the round as one ``jit(shard_map(...))`` program over
the ``client`` axis of a device mesh.  Here the round is SPMD over the
ranks of a process group (NCCL on the card, gloo on the CPU): every rank
stages the same padded cohort on the host, takes its contiguous block of
clients (:class:`~.layout.MeshLayout`), runs them through the sp engine's
per-client body (the same ``LocalTrainer`` and ``torch.func.vmap`` client
map), and the merge runs over the process group.  Which aggregates the
merge computes is the algorithm's spec (``core/federated.py``), built with
this engine's reducer:

- ``replicated``: ``PsumReducer``; each leaf's weighted numerator is
  all-reduced and every rank runs the full server update;
- ``scatter`` (the default above one shard): ``ScatterReducer``, the
  layout of arXiv:2004.13336: the numerators flatten into one padded
  vector and reduce-scatter, so each rank receives only its chunk;
  ``ServerOptimizer.update_shard`` transitions that chunk (FedOpt's
  moments, SCAFFOLD's ``c_server``, FedDyn's ``h`` and Mime's momentum stay
  on their rank) and the new params come back by one all-gather.

``collective_precision`` bf16/int8 quantizes the merge numerator against
this rank's error-feedback row and, in the scatter layout, the broadcast
chunk too, with the server update on the shard-resident fp32 master.

Per-client randomness does not depend on the rank: every rank draws the
whole cohort's dropout masks from the round's generator, as the sp engine
does, and takes its block; the quantization noise of shard ``i`` comes
from a generator of its own (``round_engine.noise_source``).  So a mesh of
any size runs the sp engine's rounds, up to the order of the f32 sums.

The per-client state table (SCAFFOLD/FedDyn) is sharded by rows over the
client shards, plus one scratch row; a round gathers its cohort's rows by
one all-reduce (each rank contributes the rows it holds) and writes them
back after one all-gather, both on the device, so a captured block holds
them.

On a 2-D ``client × model`` mesh (``mesh_shape="c,m"``, :mod:`.layout`)
the params, the table's rows and (replicated layout) the server's
param-shaped trees rest sharded over the model group, the flat server
state in ``c·m`` chunks.  A round gathers the params over the model group,
every rank runs its block of the cohort padded to ``c·m`` rows (the FSDP
form of the JAX package's GSPMD train phase: no client runs twice, no rank
idles), and the sums come back into the resting layout: the scatter
merge reduce-scatters the flat numerator over every rank (chunk = rank,
the JAX package's ``P(("client", "model"))`` order); the replicated merge
reduce-scatters each leaf over its model group and all-reduces that
``1/m`` shard over the client group, and the server update runs on the
shards (every transition is elementwise).  A quantized merge sums the
model group's contributions in f32 first and quantizes once a client
shard, against that shard's EF row (its columns over the model group).

On the 3-D ``client × stage × model`` pipeline layout (``mesh_shape=
"c,s,m"`` on a staged model, :mod:`.layout`, :mod:`.pipeline`) the cohort
spreads over the client shards only: the ``s·m`` ranks of a shard train
its clients one after another, each step a microbatched pipeline over the
stage ring on the rank's own layer chunk (no gather), and every
reduction over the cohort runs over the client group.  The replicated
merge all-reduces each rank's shards over the client group; the scatter
merge places each rank's shards into whole leaves (zero elsewhere,
``layout.place``) and reduce-scatters the flat vector over every rank,
chunk = rank; the EF rows' columns chunk over ``(stage, model)``.

The client-state plane: ``registered_clients``, ``client_store`` (each
rank's host store holds its client shard's ids and its shard of each row,
and a round runs on a device mini-table of the cohort's rows),
``data_paging`` and ``checkpoint_dir`` (the whole state and client state,
saved by rank 0; :meth:`MeshFedAvgAPI.maybe_resume`).

``round_block`` K > 1 replays each round of a block as a CUDA graph on the
card (``round_engine.BlockRoundFn``) with the merge's NCCL collectives
captured inside the graph, and on the pipeline layout the stage ring's
send/recv too.

The obs plane runs as on the sp engine (``trace``, ``health``,
``metrics_port``): the ObsCarry row carries the byte model of
:meth:`MeshFedAvgAPI.collective_bytes` split per axis, and the health
lanes are gathered from the ranks (pad rows weight 0), on every layout.
``trace_device`` is refused by name here (the JAX engine warns and keeps
the FLOP model).
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np
import torch

from ...core import federated
from ...core import rng as rng_util
from ...core.compression import blockscale
from ...core.flatmodel import FlatSpec
from ...ml.aggregator.agg_operator import ServerOptimizer, ServerState
from ...ml.trainer.local_trainer import LocalTrainer
from ...obs.carry import OPT_FLOPS, round_obs
from ..round_engine import BlockRoundFn, draw_dropout, ef_numerator, \
    next_pow2, param_delta, payload_noise
from ..sp.fedavg_api import FedAvgAPI
from ..staging import AsyncCohortStager
from .collectives import (client_axis_bytes, model_axis_bytes,
                          stage_axis_bytes, wire_cast)
from .layout import MeshLayout

log = logging.getLogger(__name__)


def _bcast_mask(own: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return own.reshape(own.shape + (1,) * (like.dim() - own.dim()))


def sharded_take(table, ids: torch.Tensor, lo: int, mesh, axis=None):
    """Rows ``ids`` of a table sharded by rows over the ranks of ``axis``
    (default: every rank; this rank holds rows ``lo .. lo + len``): each
    rank fills the rows it holds, zeros elsewhere, and one all-reduce per
    leaf assembles them.  An id no rank holds reads as zeros.  ``table``:
    a tensor or a dict of them; ``ids``: any shape of int64."""
    def take(t):
        local = ids - lo
        own = (local >= 0) & (local < t.shape[0])
        rows = t[torch.where(own, local, 0)]
        return mesh.psum(torch.where(_bcast_mask(own, rows), rows,
                                     torch.zeros((), dtype=t.dtype,
                                                 device=t.device)),
                         axis=axis)
    if isinstance(table, torch.Tensor):
        return take(table)
    return {k: take(t) for k, t in table.items()}


def make_mesh_round_core(trainer: LocalTrainer, server_opt: ServerOptimizer,
                         layout: MeshLayout, update_sharding: str,
                         flat: FlatSpec, flat_pad: FlatSpec = None,
                         collective_precision: str = "fp32",
                         quant_block: int = blockscale.DEFAULT_BLOCK,
                         train_x=None, train_y=None, data_lo=None,
                         obs_bytes=None, health: bool = False):
    """``core(state, data, mask, w, drop, cohort, table, noise,
    inplace=False) -> (new_state, metrics, table)``: one round on this
    rank.

    ``data`` is the whole padded cohort: its ``(C, S, B)`` index tensor
    over the device-resident dataset (``train_x``/``train_y``; this rank's
    row block of it when ``data_lo`` is set, the ``sharded`` mode), or the
    ``(x, y)`` batches (``host``).  ``mask`` ``(C, S)`` and ``w`` ``(C,)``
    are whole too; ``drop`` holds this rank's block of dropout masks;
    ``cohort`` ``(C,)`` the client ids (the sentinel on pad rows) that
    index the row-sharded ``table`` (``None`` without per-client state),
    which has one scratch row past this rank's rows.  ``noise(slot, kind,
    shape)`` is this shard's rounding noise.  ``flat`` is the params'
    unpadded flat view, ``flat_pad`` the scatter layout's padded one.
    ``inplace`` writes the table rows into ``table`` (the graph's static
    buffers).  On a 2-D mesh ``state``'s params (and in the replicated
    layout its param-shaped trees) and the table's rows are this rank's
    model shards; ``flat_pad`` is then the padded view in both layouts.

    ``obs_bytes(steps)`` (the engine's byte model, a dict with ``client``,
    ``stage``, ``model`` and ``total``) turns on the ObsCarry row in
    ``metrics["obs"]``; ``health`` the cohort's ``(C,)`` health lanes in
    ``metrics["health"]`` (pad rows weight 0), gathered from the ranks.
    Sums over a rank's shards count each leaf once
    (``layout.leaf_weight``) and reduce over the client shard's ranks; on
    2-D the lanes compare whole client params with the whole update (its
    params gathered, as the train phase gathers the old ones)."""
    mesh = layout.mesh
    spec = server_opt.spec
    scatter = update_sharding == "scatter"
    precision = collective_precision
    quantized = precision != "fp32"
    if quantized and not spec.avg_params:
        raise ValueError(
            f"collective_precision={precision!r} quantizes the avg_params "
            f"merge numerator, which the {server_opt.algorithm!r} spec "
            "does not use")
    two_d, pipe = layout.two_d, layout.pipeline
    if (scatter or layout.sharded) and flat_pad is None:
        raise ValueError("the scatter layout and a 2-D or 3-D mesh need the "
                         "padded flat view")
    if pipe:
        from .pipeline import make_pipeline_cohort
        program = make_pipeline_cohort(trainer, spec, server_opt)
    else:
        program = federated.RoundProgram(spec, trainer.make_local_train(),
                                         server_opt, "vmap")
    n, rank = layout.n_ranks, layout.rank
    #: the ranks the cohort's clients spread over (None: every rank)
    cohort = layout.cohort_axis
    opt_flops = OPT_FLOPS.get(server_opt.algorithm, 4.0)
    #: the scatter merge's broadcast residual of the round (obs only)
    qerr = {}

    def cohort_data(data, rows):
        if train_x is None:
            x, y = data
            return x[rows], y[rows]
        idx = data.to(torch.long)
        if data_lo is None:
            idx = idx[rows]
            return train_x[idx], train_y[idx]
        # dataset rows sharded over the row shards: one all-reduce
        # assembles the cohort's examples on every rank
        return (sharded_take(train_x, idx, data_lo, mesh, cohort)[rows],
                sharded_take(train_y, idx, data_lo, mesh, cohort)[rows])

    def table_gather(table, cohort_ids, rows):
        """This rank's clients' rows of the row-sharded table (on 2-D its
        block's rows gathered over the model group first; on 3-D the rows
        stay this rank's shards, as the pipeline trains on them)."""
        held = next(iter(table.values())).shape[0] - 1
        block = {k: t[:held] for k, t in table.items()}
        if two_d:
            block = layout.gather_tree(block, off=1)
        got = sharded_take(block, cohort_ids, layout.c_coord * held, mesh,
                           axis="client" if layout.sharded else None)
        return {k: v[rows] for k, v in got.items()}

    def table_scatter(table, cohort_ids, new_rows, inplace):
        """The cohort's new rows (every row shard's, all-gathered) written
        into the rows this rank holds (on 2-D their model shards); the
        others go to the scratch row."""
        held = next(iter(table.values())).shape[0] - 1
        local = cohort_ids - layout.c_coord * held
        local = torch.where((local >= 0) & (local < held), local, held)
        new_rows = {k: mesh.all_gather(v, axis=cohort)
                    for k, v in new_rows.items()}
        if two_d:
            new_rows = layout.shard_tree(new_rows, off=1)
        if inplace:
            for k, t in table.items():
                t.index_copy_(0, local, new_rows[k].to(t.dtype))
            return table
        return {k: t.index_copy(0, local, new_rows[k].to(t.dtype))
                for k, t in table.items()}

    def ef_sharded(state: ServerState, outs, w, den, noise):
        """The EF-quantized numerator on 2-D and 3-D: the client shard's
        contributions summed in f32 over its ranks (2-D: its model group's
        clients; 3-D: the shards of its clients, placed whole), plus the
        shard's EF row (gathered from its column chunks), quantized with
        the shard's slot-0 noise.  Returns ``(deq, new_ef_cols)``: the
        whole dequantized payload (the same on every rank of the client
        shard) and this rank's chunk of the new residual row."""
        part = flat_pad.flatten(layout.place(
            federated.weighted_sums(outs.params, w))) / den
        v = mesh.psum(part, axis=layout.shard_axis) + \
            mesh.all_gather(state.ef_num[0], axis=layout.shard_axis)
        deq, _ = blockscale.collective_quantize(
            v, precision, payload_noise(noise, 0, precision, v.shape[0],
                                        quant_block), quant_block)
        per = v.shape[0] // layout.n_shard_ranks
        lo = layout.shard_coord * per
        return deq, (v - deq)[None, lo:lo + per]

    def merge_replicated(state: ServerState, full, outs, w, noise):
        if two_d:
            red = federated.Psum2DReducer(layout)
        else:
            red = federated.PsumReducer(mesh, cohort)
        if not quantized:
            agg = federated.build_aggregates(spec, red, server_opt, state,
                                             outs, w)
            return server_opt.update_from_aggregates(state, agg)
        # the EF-quantized numerator: this shard's contribution to the
        # average plus its residual row, quantized, all-reduced at the
        # wire precision; auxiliary aggregates stay fp32
        agg = federated.build_aggregates(spec, red, server_opt, state, outs,
                                         w, include_avg=False)
        den = mesh.psum(torch.sum(w), cohort)
        if layout.sharded:
            deq, new_ef = ef_sharded(state, outs, w, den, noise)
            agg["avg_params"] = layout.shard_tree(flat_pad.unflatten(
                mesh.psum(wire_cast(deq, precision),
                          axis="client").to(torch.float32)))
        else:
            deq, new_ef = ef_numerator(state, flat, outs, w, den, noise,
                                       precision, quant_block)
            agg["avg_params"] = flat.unflatten(
                mesh.psum(wire_cast(deq, precision)).to(torch.float32))
        new_state = server_opt.update_from_aggregates(state, agg)
        return new_state.replace(ef_num=new_ef)

    def merge_scatter(state: ServerState, full, outs, w, noise):
        red = federated.ScatterReducer(flat_pad, mesh, cohort, layout.place)
        fields = {}
        if quantized:
            agg = federated.build_aggregates(spec, red, server_opt, state,
                                             outs, w, include_avg=False)
            den = mesh.psum(torch.sum(w), cohort)
            if layout.sharded:
                deq, fields["ef_num"] = ef_sharded(state, outs, w, den, noise)
                summed = mesh.psum(wire_cast(deq, precision), axis="client")
                agg["avg_params"] = flat_pad.chunk(summed, rank, n).to(
                    torch.float32)
            else:
                deq, fields["ef_num"] = ef_numerator(
                    state, flat_pad, outs, w, den, noise, precision,
                    quant_block)
                agg["avg_params"] = mesh.psum_scatter(
                    wire_cast(deq, precision)).to(torch.float32)
            # the chunk transitions from the shard-resident fp32 master:
            # global_params is the quantized copy the clients trained from
            gshard = state.master_flat
        else:
            agg = federated.build_aggregates(spec, red, server_opt, state,
                                             outs, w)
            gshard = flat_pad.chunk(flat_pad.flatten(full), rank, n)
        new_gshard, new_fields = server_opt.update_shard(state, gshard, agg)
        fields.update(new_fields)
        out_chunk = new_gshard
        if quantized:
            send, new_ef_bcast, berr_sq = blockscale.quantize_broadcast(
                new_gshard, state.ef_bcast, precision,
                payload_noise(noise, 1, precision, new_gshard.shape[0],
                              quant_block, broadcast=True), quant_block)
            fields["master_flat"] = new_gshard
            if state.ef_bcast is not None:
                fields["ef_bcast"] = new_ef_bcast
            out_chunk = wire_cast(send, precision)
            if obs_bytes is not None:
                qerr["bcast"] = berr_sq
        new_params = layout.shard_tree(flat_pad.unflatten(
            mesh.all_gather(out_chunk).to(torch.float32)))
        return state.replace(round_idx=state.round_idx + 1,
                             global_params=new_params, **fields)

    def core(state: ServerState, data, mask, w, drop, cohort_ids, table,
             noise=None, inplace: bool = False):
        rows = layout.local_rows(mask.shape[0])
        x, y = cohort_data(data, rows)
        mask, w = mask[rows], w[rows]
        c = None if table is None else table_gather(table, cohort_ids, rows)
        # on 2-D the params rest sharded over the model group: whole for
        # the train phase; on 3-D the pipeline trains on the shards, and
        # only the scatter merge reads the whole params
        full = state.global_params
        if two_d or (pipe and scatter and not quantized):
            full = layout.gather_tree(state.global_params)
        ctx_state = state.replace(global_params=full) if two_d else state
        if scatter:
            # client-visible server state (SCAFFOLD's c_server in the
            # corrected gradient, Mime's momentum in the client step) is
            # shard-resident: gather it whole for the train phase (this
            # rank's shards of it on 3-D)
            gathered = {f: flat_pad.unflatten(mesh.all_gather(
                getattr(state, f))) for f in ("c_server", "momentum")
                if getattr(state, f) is not None}
            if pipe:
                gathered = {f: layout.shard_tree(v)
                            for f, v in gathered.items()}
            ctx_state = ctx_state.replace(**gathered)
        elif two_d:
            gathered = {f: layout.gather_tree(getattr(state, f))
                        for f in ("c_server", "momentum")
                        if getattr(state, f) is not None}
            ctx_state = ctx_state.replace(**gathered)
        outs = program.run_clients(ctx_state, x, y, mask, drop, c)
        merge = merge_scatter if scatter else merge_replicated
        new_state = merge(state, full, outs, w, noise)
        if table is not None:
            table = table_scatter(table, cohort_ids, outs.new_client_state,
                                  inplace)
        sums = mesh.psum(torch.stack([
            torch.sum(outs.loss * w), torch.sum(w),
            torch.sum(outs.num_steps).to(torch.float32)]), cohort)
        metrics = {"train_loss": sums[0] / sums[1], "total_steps": sums[2]}
        if obs_bytes is not None:
            metrics["obs"] = obs_row(state, new_state, x, w, sums)
        if health:
            metrics["health"] = health_rows(state, new_state, full, outs, w,
                                            sums)
        return new_state, metrics, table

    def shard_sums(tensors):
        """Sums of per-rank shard terms over the client shard's ranks (the
        identity on 1-D)."""
        if not layout.sharded:
            return tensors
        return mesh.psum_many(tensors, axis=layout.shard_axis)

    def obs_row(state, new_state, x, w, sums):
        old, new = state.global_params, new_state.global_params
        sq = sum(layout.leaf_weight(k) * torch.sum(
            (new[k].to(torch.float32) - v.to(torch.float32)) ** 2)
            for k, v in old.items())
        (sq,) = shard_sums([sq.reshape(1)])
        clients = mesh.psum(torch.sum((w > 0).to(torch.float32)), cohort)
        qnorm = None
        if quantized:
            # each shard's merge residual (this rank's EF row or chunk)
            # and, in the scatter layout, the broadcast residual, over
            # every rank
            q = torch.sum(new_state.ef_num.to(torch.float32) ** 2)
            if "bcast" in qerr:
                q = q + qerr.pop("bcast")
            qnorm = torch.sqrt(mesh.psum(q))
        b = obs_bytes(int(x.shape[1]))
        return round_obs(
            old, new, real_steps=sums[2], real_clients=clients,
            batch=int(x.shape[2]), feat=math.prod(x.shape[3:]),
            opt_flops_per_param=opt_flops, collective_bytes=b["total"],
            collective_bytes_client=b["client"],
            collective_bytes_stage=b["stage"],
            collective_bytes_model=b["model"], quant_error=qnorm,
            sq=sq[0], n_params=flat.n_params)

    def health_rows(state, new_state, full, outs, w, sums):
        old, new = state.global_params, new_state.global_params
        if two_d:
            # whole client params against the whole update
            old, new = full, layout.gather_tree(new)
        sq, dot, ref_sq = federated.health_sums(
            old, outs.params, param_delta(new, old),
            leaf_weight=layout.leaf_weight if pipe else None)
        if pipe:
            sq, dot, ref_sq = shard_sums([sq, dot, ref_sq.reshape(1)])
            ref_sq = ref_sq[0]
        lanes = federated.health_lanes(
            sq, dot, ref_sq, outs.loss, w,
            mean_loss=sums[0] / torch.clamp(sums[1], min=1e-12))
        return {f: mesh.all_gather(v, axis=cohort) for f, v in lanes.items()}

    return core


def local_dropout(model, generator, n_real: int, lead, rows: slice):
    """This rank's block of a round's dropout masks: the whole cohort's
    ``n_real`` clients drawn as the sp engine draws them, zero masks for
    the pad rows up to ``lead[0]``, then the rows ``rows``."""
    drop = draw_dropout(model, generator, (n_real,) + tuple(lead[1:]))
    if drop is None:
        return None
    pad = lead[0] - n_real
    out = []
    for d in drop:
        if pad:
            d = torch.cat([d, torch.zeros((pad,) + tuple(d.shape[1:]),
                                          dtype=d.dtype, device=d.device)])
        out.append(d[rows])
    return tuple(out)


class MeshBlockRoundFn(BlockRoundFn):
    """:class:`~..round_engine.BlockRoundFn` over the mesh round core: the
    staged block holds the whole padded cohort, each round draws the
    cohort's dropout masks and keeps this rank's block, and the round
    gathers and writes its table rows itself (row-sharded)."""

    def __init__(self, core, model, has_table: bool, n_real: int,
                 layout: MeshLayout):
        super().__init__(core, model, has_table)
        self.n_real = n_real
        self.layout = layout

    def _draw(self, gen, lead):
        return local_dropout(self.model, gen, self.n_real, lead,
                             self.layout.local_rows(lead[0]))

    def _round(self, state, idx, mask, w, drop, cohort, table, hp,
               inplace: bool):
        return self.core(state, idx, mask, w, drop, cohort, table, None,
                         inplace)


class _MeshStoreView:
    """A mesh engine's client store as ``core/checkpoint.py`` sees a
    store: ``to_checkpoint`` gives the whole rows gathered from every
    rank, ``load_checkpoint``/``load_dense`` give each rank its part."""

    def __init__(self, api, payload=None):
        self.api = api
        self.payload = payload

    def to_checkpoint(self):
        return self.payload

    def load_checkpoint(self, payload):
        self.api._load_store_payload(payload)

    def load_dense(self, table):
        rows = next(iter(table.values())).shape[0]
        payload = {"ids": np.arange(rows, dtype=np.int64)}
        for i, name in enumerate(sorted(table)):
            payload[f"leaf_{i}"] = table[name].detach().cpu().numpy()
        self.api._load_store_payload(payload)


class MeshFedAvgAPI(FedAvgAPI):
    """The sp engine's driver surface; rounds run over the mesh.

    ``mesh``: a :class:`~fedml_tpu_torch.core.mesh.Mesh`, else the one
    ``args`` names (``mesh_shape`` ``"c,m"`` or ``"c,s,m"``, else the
    ``mesh_*`` knobs) over the process group, made as a world of 1 when
    there is none.  ``n_shards`` is the client factor,
    ``n_stage_shards`` the stage factor, ``n_model_shards`` the model
    factor; on 2-D and 3-D ``state.global_params`` holds this rank's
    shards (``full_params()``/``full_state()`` gather them); on 3-D
    ``microbatches`` splits each batch of the pipeline.  ``device`` is the
    mesh's.  ``args.update_sharding``: "replicated" | "scatter" | "auto"
    (scatter above one shard).  ``args.device_data``: True/"replicated"
    (the dataset on every rank), "sharded" (rows split over the ranks) or
    False/"host" (cohort batches staged on the host).
    ``args.async_staging`` (default True) builds round r+1's cohort on a
    worker thread while round r runs.

    The client-state plane: ``registered_clients`` widens the sampled id
    space (the table's rows are registered ids); ``client_store`` keeps
    the per-client rows in a sparse host store on each rank, holding the
    ids of its client shard (``id // held == c_coord``) and its shard of
    each row, paged in ahead of the round and written back after it; the
    round runs on a device mini-table of the cohort's rows (one block of
    slots a client shard, the same shape every round, so a fused block
    keeps its buffers); ``data_paging`` stages the cohort's examples from
    the sp engine's paged store; ``checkpoint_dir`` saves the whole state
    (``full_state()``) and the whole client state from rank 0 and restores
    them into any mesh whose flat padding and client factor match
    (``load_full_state``)."""

    #: the client store, data paging, a registered population and
    #: checkpoints run on the mesh (the class docstring)
    CLIENT_STATE_PLANE = True

    #: the ``trace_device`` probe splits an sp round only (refused here)
    DEVICE_PROBE = False

    def __init__(self, args, device, dataset, model, mesh=None):
        from .pipeline import validate_pipeline_args
        # refused before any process group is made
        self._refuse_options(args)
        validate_pipeline_args(args)
        if mesh is None:
            from ...device import get_device
            device = get_device(args, device)
        self.layout = MeshLayout.from_args(args, mesh, device, model)
        self.mesh = self.layout.mesh
        self.n_shards = self.layout.n_client_shards
        self.n_stage_shards = self.layout.n_stage_shards
        self.n_model_shards = self.layout.n_model_shards
        self.rank = self.layout.rank
        mode = str(getattr(args, "update_sharding", "auto") or "auto").lower()
        if mode == "auto":
            mode = "scatter" if self.layout.n_ranks > 1 else "replicated"
        if mode not in ("replicated", "scatter"):
            raise ValueError(
                f"update_sharding must be 'replicated', 'scatter' or "
                f"'auto', got {mode!r}")
        self.update_sharding = mode
        super().__init__(args, self.mesh.device, dataset, model,
                         client_mode="vmap")
        self._stager = AsyncCohortStager(
            self._stage_cohort,
            enabled=bool(getattr(args, "async_staging", True)),
            depth=int(getattr(args, "staging_depth", 1) or 1),
            limit=self.comm_rounds)

    @property
    def scatter(self) -> bool:
        return self.update_sharding == "scatter"

    def _make_trainer(self, model, args, algorithm):
        """On the pipeline layout the microbatched pipeline trainer (its
        gradient replaced, every optimizer and SCAFFOLD step
        :class:`LocalTrainer`'s)."""
        if not self.layout.pipeline:
            return super()._make_trainer(model, args, algorithm)
        from .pipeline import PipelineTrainer, check_pipeline_shapes
        micro = int(getattr(args, "microbatches", 1) or 1)
        check_pipeline_shapes(model, self.layout,
                              int(getattr(args, "batch_size", 10)), micro)
        return PipelineTrainer(model, args, self.layout, micro, algorithm)

    # -- state and tables ----------------------------------------------------
    def _init_server_state(self, params):
        """This rank's part of the initial state: in the scatter layout
        the chunks of the flat aux vectors (``init_sharded``), in the
        replicated one the whole aux trees; with quantized collectives its
        EF row (the replicated merge quantizes only the numerator, so its
        params stay fp32 and it keeps no master).  On 2-D the params and
        trees are this rank's model shards, the EF row its column chunk
        (over the padded flat view)."""
        self.layout.bind(FlatSpec.of(params, 1, self.model.flat_layout()))
        self.flat_pad = None
        if self.scatter or self.layout.sharded:
            self.flat_pad = self.layout.flat_spec_of(
                params, self.model.flat_layout())
        if self.scatter:
            whole = self.server_opt.init_sharded(
                params, self.n_shards, self.flat_pad,
                collective_precision=self.collective_precision)
        else:
            whole = self.server_opt.init(
                params, collective_precision=self.collective_precision,
                ef_shards=self.n_shards, quantized_broadcast=False,
                flat=self.flat_pad if self.layout.sharded else self.flat)
        return self.layout.shard_state(whole, self.scatter)

    def _init_client_table(self):
        """This rank's block of the per-client state table (one row per
        registered id, padded to a multiple of the client shards; on 2-D
        and 3-D each row this rank's shard) plus one scratch row; pad rows
        of a cohort carry the sentinel id (:meth:`_sentinel`)."""
        from ...core import tree as tree_util
        return tree_util.client_table_init(
            self.state.global_params, self._held() + 1)

    def _held(self) -> int:
        """Rows of the per-client state a client shard holds."""
        return self._sentinel() // self.n_shards

    def _spill_dir(self, path):
        if path and self.layout.n_ranks > 1:
            return os.path.join(path, f"rank{self.rank}")
        return path

    def _cohort_ids_for(self, round_idx: int) -> np.ndarray:
        """The ids round (or block) ``round_idx`` touches that this rank's
        client shard holds: what its store pages in."""
        ids = np.asarray(super()._cohort_ids_for(round_idx))
        return ids[ids // self._held() == self.layout.c_coord]

    def _mini_table(self, round_idx: int, cohort, stride: int):
        """The round's (or block's) rows from the store as a device
        mini-table: ``n_slots`` rows a client shard (the cohort's size
        times the block's rounds) plus the scratch row, this rank holding
        its client shard's; each id of ``cohort`` mapped to its slot
        ``owner · n_slots + rank among the owner's ids`` (the sentinel
        past every slot).  Returns ``(slots, mini-table, ids)``, the ids
        this rank writes back, padded with an id the store drops."""
        held = self._held()
        flat = np.asarray(cohort, np.int64).reshape(-1)
        n_slots = flat.shape[0]
        real = np.unique(flat[flat < self._sentinel()])
        owner = real // held
        slots = np.full(flat.shape, self.n_shards * n_slots, np.int64)
        for j in range(self.n_shards):
            ids_j = real[owner == j]
            hit = np.isin(flat, ids_j)
            slots[hit] = j * n_slots + np.searchsorted(ids_j, flat[hit])
        mine = real[owner == self.layout.c_coord]
        nxt = round_idx + stride
        rows = self._pager.gather(
            round_idx, mine, prefetch=nxt if nxt < self.comm_rounds else None)
        mini = {k: torch.as_tensor(np.concatenate(
            [r, np.zeros((n_slots + 1 - len(mine),) + r.shape[1:],
                         r.dtype)])).to(self.device)
                for k, r in rows.items()}
        ids = np.full(n_slots + 1, self.registered_clients, np.int64)
        ids[:len(mine)] = mine
        return slots.reshape(np.shape(cohort)), mini, ids

    def _block_mini_table(self, start_round: int, cohort_blk):
        return self._mini_table(start_round, cohort_blk, self._round_block)

    def full_state(self) -> ServerState:
        """The whole server state, as one controller would hold it: the
        shard-resident vectors and EF rows gathered (a collective)."""
        return self.layout.gather_state(self.state, self.scatter)

    def full_client_table(self):
        """The whole per-client table, ``(num_clients, ...)`` rows
        gathered from every rank (a collective), or ``None``."""
        if self.client_table is None:
            return None
        n = self.registered_clients
        block = self.layout.gather_tree(
            {k: t[:-1] for k, t in self.client_table.items()}, off=1)
        axis = "client" if self.layout.sharded else None
        return {k: self.mesh.all_gather(t, axis=axis)[:n]
                for k, t in block.items()}

    def collective_bytes(self, steps=None) -> dict:
        """Modeled interconnect payload bytes a round, per mesh axis (the
        JAX engine's byte model): the client axis prices the merge (the
        replicated merge's payload is a rank's ``1/(s·m)`` shard), the
        model and stage axes the scatter layout's two flat-view moves,
        and on the pipeline layout the stage axis also the activation
        shifts of ``steps`` local steps (default: the last round's)."""
        mode = self.update_sharding
        m, s = self.n_model_shards, self.n_stage_shards
        n_flat = self.flat_pad.padded_size if self.scatter \
            else self.flat.n_params
        n_payload = n_flat if self.scatter else -(-n_flat // (m * s))
        client = client_axis_bytes(n_payload, self.n_shards,
                                   self.collective_precision,
                                   self.quant_block, mode)
        model = model_axis_bytes(n_flat, m, mode=mode)
        stage = 0.0
        if self.layout.pipeline:
            micro = self.trainer.n_micro
            stage = stage_axis_bytes(
                n_flat, s, mode=mode, hidden=self.trainer.pipe.hidden,
                microbatch=self.batch_size // micro, n_micro=micro,
                steps=getattr(self, "_last_steps", 0) if steps is None
                else steps)
        return {"client": client, "stage": stage, "model": model,
                "total": client + stage + model}

    def full_params(self):
        """The whole global params (on 2-D gathered over the model group:
        a collective)."""
        return self.layout.gather_tree(self.state.global_params)

    def load_full_state(self, state: ServerState, table=None) -> None:
        """Restart from a whole state (``full_state()``'s form, e.g. read
        back with ``core/checkpoint.py::state_from_flat``) and the whole
        table (``full_client_table()``'s form): this rank keeps its part
        of each."""
        dev = self.device

        def to(v):
            if isinstance(v, torch.Tensor):
                return v.to(dev)
            if isinstance(v, dict):
                return {k: t.to(dev) for k, t in v.items()}
            return v

        state = state.replace(**{f: to(getattr(state, f)) for f in (
            "global_params", "opt_state", "c_server", "h", "momentum",
            "ef_num", "master_flat", "ef_bcast")})
        self.layout.bind(FlatSpec.of(state.global_params, 1,
                                     self.model.flat_layout()))
        self.state = self.layout.shard_state(state, self.scatter)
        if table is not None and self.client_table is not None:
            held = next(iter(self.client_table.values())).shape[0] - 1
            lo = self.layout.c_coord * held
            for k, t in self.client_table.items():
                rows = self.layout.shard_tree(
                    {k: table[k][lo:lo + held].to(dev)}, off=1)[k]
                t[:rows.shape[0]] = rows.to(t.dtype)

    # -- checkpoints ---------------------------------------------------------
    def _store_payload(self) -> dict:
        """The client store's written rows, whole, in the store's
        checkpoint form (a collective): every rank's rows all-gathered as
        objects, each client shard's row shards joined."""
        import torch.distributed as dist
        local = self._store.to_checkpoint()
        every = [None] * self.layout.n_ranks
        dist.all_gather_object(every, local)
        per = self.layout.n_shard_ranks
        names = sorted(self.state.global_params)
        ids, leaves = [], [[] for _ in names]
        for c in range(self.n_shards):
            got = every[c * per:(c + 1) * per]
            ids.append(got[0]["ids"])
            for i, name in enumerate(names):
                leaves[i].append(self._join_rows(
                    name, [g[f"leaf_{i}"] for g in got]))
        out = {"ids": np.concatenate(ids), "registered": local["registered"]}
        out.update({f"leaf_{i}": np.concatenate(rows)
                    for i, rows in enumerate(leaves)})
        return out

    def _join_rows(self, name: str, parts) -> np.ndarray:
        """Whole rows of leaf ``name`` from its shards on a client shard's
        ranks (``parts`` in their order: stage-major, then model)."""
        axes = {axis: d + 1 for d, axis in self.layout._splits(name)}
        n_model = self.n_model_shards
        per_stage = []
        for st in range(self.n_stage_shards if "stage" in axes else 1):
            row = [parts[st * n_model + m] for m in range(
                n_model if "model" in axes else 1)]
            per_stage.append(np.concatenate(row, axes["model"])
                             if "model" in axes else row[0])
        return np.concatenate(per_stage, axes["stage"]) \
            if "stage" in axes else per_stage[0]

    def _load_store_payload(self, payload) -> None:
        """This rank's part of a whole store checkpoint: the ids its client
        shard holds, its shard of each row."""
        ids = np.asarray(payload["ids"], np.int64)
        keep = ids // self._held() == self.layout.c_coord
        rows = {}
        for i, name in enumerate(sorted(self.state.global_params)):
            t = torch.as_tensor(np.asarray(payload[f"leaf_{i}"])[keep])
            rows[name] = self.layout._slice(
                t, self.layout._splits(name), off=1).numpy()
        self._store.scatter(ids[keep], rows)

    def _barrier(self) -> None:
        self.mesh.psum(torch.zeros(1, device=self.device))

    def maybe_checkpoint(self, round_idx: int, window: int = 1):
        """The sp engine's schedule; the whole state and client state
        gathered on every rank (collectives) and saved by rank 0."""
        from ...core.checkpoint import state_to_flat
        ckpt = self._checkpointer()
        if ckpt is None or not self._checkpoint_due(round_idx, window):
            return
        client = None
        if self._pager is not None:
            self._pager.drain_writebacks()
            client = _MeshStoreView(self, self._store_payload())
        elif self.client_table is not None:
            client = self.full_client_table()
        flat = state_to_flat(self.full_state())
        if self.rank == 0:
            ckpt.save(round_idx, flat, client)
        self._barrier()

    def maybe_resume(self) -> int:
        """Restore the latest checkpoint into this mesh (any mesh whose
        flat padding and client factor match the saver's): every rank
        reads the whole state and keeps its part.  Returns the round to
        start from."""
        from ...core.checkpoint import state_from_flat, state_to_flat
        ckpt = self._checkpointer()
        if ckpt is None or ckpt.latest_round() is None:
            return 0
        like = self.full_state()
        template = None
        if self._store is not None:
            template = _MeshStoreView(self)
        elif self.client_table is not None:
            template = self.full_client_table()
        flat, client = ckpt.restore(template=(state_to_flat(like), template))
        self.load_full_state(state_from_flat(flat, like),
                             client if self.client_table is not None
                             else None)
        return int(ckpt.latest_round()) + 1


    # -- the round -----------------------------------------------------------
    def _build_round_fn(self, client_mode: str):
        mode = getattr(self.args, "device_data", True)
        if isinstance(mode, str):
            mode = mode.lower()
        # a paged training set is never uploaded whole: host-staged
        self._gather = mode not in (False, "host", "off") and \
            not bool(getattr(self.args, "data_paging", False))
        self._sharded_data = mode == "sharded"
        train_x = train_y = data_lo = None
        if self._gather:
            tx = torch.as_tensor(self.dataset.train_x)
            ty = torch.as_tensor(self.dataset.train_y)
            if self._sharded_data:
                # this rank's block of the rows: resident memory per rank
                # is |dataset| / n_shards (pad rows are never indexed)
                rows = self.layout.local_rows(
                    self.layout.pad_rows(tx.shape[0]))
                data_lo = rows.start
                tx, ty = tx[rows], ty[rows]
            train_x = tx.to(self.device)
            train_y = ty.to(self.device)
            self._dev_data = (train_x, train_y)
        return make_mesh_round_core(
            self.trainer, self.server_opt, self.layout, self.update_sharding,
            self.flat, self.flat_pad, self.collective_precision,
            self.quant_block, train_x, train_y, data_lo,
            obs_bytes=self.collective_bytes if self._obs else None,
            health=self._health)

    def _n_cohort(self) -> int:
        return min(self.clients_per_round, self.dataset.num_clients)

    def _stage_cohort(self, round_idx: int):
        """One round's whole cohort on the host, its rows padded to a
        multiple of the shard count (zero weight, the sentinel id) and its
        steps to a power of two.  A pure function of the round index, so
        the stager may build it ahead on its worker thread."""
        clients = self._client_sampling(round_idx)
        n = len(clients)
        pad_c = self.layout.pad_rows(n) - n
        if self._gather:
            idx, mask, w = self.dataset.cohort_indices(
                self._data_ids(clients), self.batch_size, self.seed,
                round_idx, self.epochs)
            arrays = [idx]
        elif self._data_pager is not None:
            x, y, mask, w = self._paged_cohort_batches(clients, round_idx)
            arrays = [x, y]
        else:
            x, y, mask, w = self.dataset.cohort_batches(
                self._data_ids(clients), self.batch_size, self.seed,
                round_idx, self.epochs)
            arrays = [x, y]
        steps = next_pow2(mask.shape[1])
        pad_s = steps - mask.shape[1]
        arrays = [np.pad(a, [(0, pad_c), (0, pad_s)]
                         + [(0, 0)] * (a.ndim - 2)) for a in arrays]
        mask = np.pad(mask, [(0, pad_c), (0, pad_s)])
        w = np.pad(w, (0, pad_c))
        cohort = np.concatenate([np.asarray(clients, np.int64),
                                 np.full(pad_c, self._sentinel(),
                                         np.int64)])
        return arrays, mask, w, cohort

    def _sentinel(self) -> int:
        """The id past every table row (the registered ids padded to a
        multiple of the client shards): a pad row's id, read as zeros and
        written nowhere."""
        return self.layout.pad_table_rows(self.registered_clients)

    def train_one_round(self, round_idx: int):
        nxt = round_idx + 1 if round_idx + 1 < self.comm_rounds else None
        arrays, mask, w, cohort = self._stager.get(round_idx, prefetch=nxt)
        gen = rng_util.round_key(self._root, round_idx)
        c_pad, steps = mask.shape
        drop = local_dropout(self.model, gen, self._n_cohort(),
                             (c_pad, steps, self.batch_size),
                             self.layout.local_rows(c_pad))
        arrays = self._to_device(*arrays)
        data = arrays[0] if self._gather else tuple(arrays)
        table = self.client_table
        if self._pager is not None:
            cohort, table, ids = self._mini_table(round_idx, cohort, 1)
        mask, w, cohort = self._to_device(mask, w, cohort)
        self.state, metrics, table = self.round_fn(
            self.state, data, mask, w, drop, cohort, table,
            self._mesh_noise(round_idx, gen))
        if self._pager is not None:
            self._pager.write_back(round_idx, ids, table)
        else:
            self.client_table = table
        metrics = dict(metrics)
        metrics["allocated_steps"] = c_pad * steps
        self._last_steps = steps
        return metrics

    def _mesh_noise(self, round_idx: int, gen):
        """The round's rounding noise: the merge's (slot 0) from this
        rank's client shard, the broadcast's (slot 1) from its rank (the
        same shard on the 1-D mesh)."""
        merge = self._noise(round_idx, gen, shard=self.layout.c_coord)
        if not self.layout.sharded:
            return merge
        bcast = self._noise(round_idx, gen, shard=self.rank)
        return lambda slot, kind, shape: (merge if slot == 0 else bcast)(
            slot, kind, shape)

    # -- evaluation of the whole params ---------------------------------------
    def _with_full_params(self, fn, *args):
        if not self.layout.sharded:
            return fn(*args)
        sharded = self.state
        self.state = sharded.replace(global_params=self.full_params())
        try:
            return fn(*args)
        finally:
            self.state = sharded

    def evaluate(self):
        """The sp engine's evaluation of the whole params (on 2-D a
        collective: every rank calls it)."""
        return self._with_full_params(super().evaluate)

    def evaluate_per_client(self, split: str = "train", batch_size: int = 64):
        return self._with_full_params(super().evaluate_per_client, split,
                                      batch_size)

    # -- fused round blocks --------------------------------------------------

    def _build_block_fn(self):
        if not self._gather:
            raise ValueError(
                "round_block fusion on the mesh engine needs device-resident "
                "data (device_data=True or 'sharded'): staging a block must "
                "ship index tensors, not cohorts")
        return MeshBlockRoundFn(self.round_fn, self.model,
                                self.client_table is not None,
                                self._n_cohort(), self.layout)

    def _stage_block(self, start_round: int):
        """One block's stacked whole-cohort arrays (host numpy), rows
        padded as :meth:`_stage_cohort` pads them, steps to the block's
        largest pow2 class, each round's own class kept."""
        k = min(self._round_block, self.comm_rounds - start_round)
        per = [self._stage_cohort(r)
               for r in range(start_round, start_round + k)]
        round_steps = [p[1].shape[1] for p in per]
        steps = max(round_steps)
        c = per[0][1].shape[0]
        idx_blk = np.zeros((k, c, steps, self.batch_size), np.int32)
        mask_blk = np.zeros((k, c, steps), np.float32)
        w_blk = np.zeros((k, c), np.float32)
        cohort_blk = np.zeros((k, c), np.int64)
        for i, (arrays, mask, w, cohort) in enumerate(per):
            s = mask.shape[1]
            idx_blk[i, :, :s] = arrays[0]
            mask_blk[i, :, :s] = mask
            w_blk[i] = w
            cohort_blk[i] = cohort
        return k, round_steps, idx_blk, mask_blk, w_blk, cohort_blk

    def train(self):
        try:
            super().train()
            return self.full_params()
        finally:
            self._stager.close()
            # the block's graphs hold the NCCL communicator: release them,
            # so that the caller may destroy the process group
            if self._block_fn is not None:
                self._block_fn.release()
