"""The federated round as one function of the cohort tensors (port of
``fedml_tpu.simulation.round_engine``)::

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

With ``collective_precision`` bf16 or int8 the merge numerator is
quantized against the error-feedback row ``state.ef_num``, the server
update transitions the fp32 ``state.master_flat``, and
``state.global_params`` becomes the quantized broadcast copy the next
round's clients train from: the single-shard form of the mesh engine's
collective layer.  The rounding noise of slot ``s`` (0: the merge, 1: the
broadcast) comes from ``child_key(child_key(round generator,
QUANT_KEY_TAG), s)``, or from a ``noise(slot, kind, shape)`` callable
the caller passes.

Three programs build on the round:

- :func:`make_block_round_fn`: K rounds as one block.  On the CPU a plain
  loop; on the card one round per (step class, cohort size) is captured as
  a CUDA graph and replayed once per round, the JAX package's
  ``jit(lax.scan(round))``.  The masks are drawn outside the graph.
- :func:`make_population_round_fn`: P experiments (a population over
  :class:`~fedml_tpu_torch.core.federated.HParams`) in one round,
  ``torch.func.vmap`` over the member axis outside the client map.
- :func:`make_bucket_agg_fn`: the partial round of one cohort bucket (the
  clients of one pow2 step class), merged exactly across buckets.
"""

from __future__ import annotations

import gc
import math
import time
import types
from typing import Callable, Optional

import torch

from ..core import federated
from ..core import rng as rng_util
from ..core.compression import blockscale
from ..core.flatmodel import FlatSpec
from ..ml.aggregator.agg_operator import ServerOptimizer, ServerState
from ..ml.trainer.local_trainer import LocalTrainer
from ..obs import torchhooks

#: ServerState fields that hold tensors (``round_idx`` is a host counter);
#: each is a ``{name: tensor}`` dict or, in the mesh's scatter layout and
#: for the quantized fields, one tensor
STATE_FIELDS = ("global_params", "opt_state", "c_server", "h", "momentum",
                "ef_num", "master_flat", "ef_bcast")

#: word the round's generator folds in for the collective layer's noise
#: (the JAX package's tag for its threefry key)
QUANT_KEY_TAG = 0x5C41E


def state_fields(state: ServerState) -> dict:
    """The state's set tensor fields, ``{field: {name: tensor} | tensor}``."""
    return {f: getattr(state, f) for f in STATE_FIELDS
            if getattr(state, f) is not None}


def noise_source(generator: torch.Generator, shard=None):
    """``noise(slot, kind, shape)`` of a round's collective layer: a child
    generator per slot of the round's quantization generator (per shard
    first on the mesh), as the JAX package folds its keys."""
    def noise(slot, kind, shape):
        base = rng_util.child_key(generator, QUANT_KEY_TAG)
        if shard is not None:
            base = rng_util.child_key(base, int(shard))
        return rng_util.child_key(base, int(slot))

    return noise


def payload_noise(noise, slot: int, precision: str, n: int, block: int,
                  broadcast: bool = False):
    """The noise argument of one quantized payload of ``n`` elements
    (``None`` where it rounds to nearest: fp32, and bf16's broadcast)."""
    if precision == "fp32" or noise is None or \
            (broadcast and precision == "bf16"):
        return None
    if precision == "bf16":
        return noise(slot, "bits", (n,))
    return noise(slot, "uniform", (-(-n // block), block))


def ef_numerator(state: ServerState, flat: FlatSpec, outs, weights, den,
                 noise, precision: str, block: int):
    """The EF-quantized merge numerator of one shard: its clients'
    weighted sum of params over ``den`` (the cohort's total weight) plus
    its error-feedback row ``state.ef_num[0]``, flattened by ``flat`` and
    quantized with slot 0's noise.  Returns ``(deq, new_ef_num)``: the
    dequantized payload and the residual row the next round adds back."""
    v = state.ef_num[0] + flat.flatten(
        federated.weighted_sums(outs.params, weights)) / den
    deq, _ = blockscale.collective_quantize(
        v, precision, payload_noise(noise, 0, precision, v.shape[0], block),
        block)
    return deq, (v - deq)[None]


def make_quantized_update(server_opt: ServerOptimizer, reducer,
                          precision: str, quant_block: int, flat: FlatSpec,
                          with_error: bool = False):
    """``update(state, outs, weights, noise, hp) -> new_state`` of the sp
    engine's quantized collective layer (one shard): stage 1 with the
    EF-quantized numerator (the auxiliary aggregates stay fp32), stage 2
    on the fp32 master, then the quantized broadcast copy.  With
    ``with_error`` it returns ``(new_state, quant_error)``, the L2 norm of
    the round's two quantization residuals (the obs row's
    ``quant_error_norm``)."""
    spec = server_opt.spec

    def update(state: ServerState, outs, weights, noise, hp=None):
        agg = federated.build_aggregates(spec, reducer, server_opt, state,
                                         outs, weights, hp,
                                         include_avg=False)
        deq, new_ef = ef_numerator(state, flat, outs, weights,
                                   torch.sum(weights), noise, precision,
                                   quant_block)
        agg["avg_params"] = flat.unflatten(deq)
        master = flat.unflatten(state.master_flat)
        new_state = server_opt.update_from_aggregates(
            state.replace(global_params=master), agg, hp)
        new_master = flat.flatten(new_state.global_params)
        send, new_ef_bcast, berr_sq = blockscale.quantize_broadcast(
            new_master, state.ef_bcast, precision,
            payload_noise(noise, 1, precision, new_master.shape[0],
                          quant_block, broadcast=True), quant_block)
        new_state = new_state.replace(global_params=flat.unflatten(send),
                                      master_flat=new_master,
                                      ef_num=new_ef,
                                      ef_bcast=new_ef_bcast)
        if not with_error:
            return new_state
        return new_state, torch.sqrt(torch.sum(new_ef * new_ef) + berr_sq)

    return update


def draw_dropout(model, generator: torch.Generator, lead):
    """The round's dropout keep-masks for every client, step and example
    (``lead`` = ``(C, S, B)``), or ``None`` for a model without dropout."""
    return model.dropout_masks(generator, tuple(lead)) \
        if model.has_dropout else None


def draw_member_dropout(model, generator: torch.Generator, lead,
                        population):
    """A population's masks, ``(P,) + lead + site``: member ``m`` draws
    from :func:`~fedml_tpu_torch.core.federated.fold_seed`'s generator, so
    members share the round's masks unless the population sweeps
    ``seed``."""
    if not model.has_dropout:
        return None
    gens = [federated.fold_seed(generator, population.member_hparams(m))
            for m in range(population.size)]
    if all(g is generator for g in gens):
        shared = draw_dropout(model, generator, lead)
        return tuple(torch.stack([d] * population.size) for d in shared)
    draws = [draw_dropout(model, g, lead) for g in gens]
    return tuple(torch.stack(site) for site in zip(*draws))


def param_delta(new_params, old_params) -> dict:
    """``new − old`` per leaf, in f32: the sync engines' health reference
    direction."""
    f32 = torch.float32
    return {k: new_params[k].to(f32) - v.to(f32)
            for k, v in old_params.items()}


def make_round_core(trainer: LocalTrainer, server_opt: ServerOptimizer,
                    mode: str = "scan", collective_precision: str = "fp32",
                    quant_block: int = blockscale.DEFAULT_BLOCK,
                    flat: FlatSpec = None, obs: bool = False,
                    health: bool = False) -> Callable:
    """``core(state, x, y, mask, weights, drop, c_clients=None, hp=None,
    noise=None) -> (new_state, metrics, new_client_state)`` with the
    dropout masks ``drop`` and the quantization noise ``noise`` given: the
    round with no randomness of its own.  A quantized
    ``collective_precision`` needs ``flat``, the params' unpadded flat
    view.

    ``obs`` adds ``metrics["obs"]``, the round's ObsCarry row
    (``obs/carry.py``), and ``health`` ``metrics["health"]``, the cohort's
    ``(C,)`` health lanes (``core/federated.py::client_health_stats``),
    both on the device and read by the caller only at its own sync.
    Neither changes the round's arithmetic."""
    from ..obs.carry import OPT_FLOPS, param_count, round_obs
    program = federated.RoundProgram(server_opt.spec,
                                     trainer.make_local_train(), server_opt,
                                     mode)
    quantized = collective_precision != "fp32"
    if quantized and not server_opt.spec.avg_params:
        raise ValueError(
            f"collective_precision={collective_precision!r} quantizes the "
            f"avg_params merge numerator, which the "
            f"{server_opt.algorithm!r} spec does not use")
    qupdate = (make_quantized_update(server_opt, program.reducer,
                                     collective_precision, quant_block, flat,
                                     with_error=obs)
               if quantized else None)
    opt_flops = OPT_FLOPS.get(server_opt.algorithm, 4.0)

    def core(state: ServerState, x, y, mask, weights, drop, c_clients=None,
             hp=None, noise=None):
        qerr = None
        if quantized:
            outs = program.run_clients(state, x, y, mask, drop, c_clients,
                                       hp)
            new_state = qupdate(state, outs, weights, noise, hp)
            if obs:
                new_state, qerr = new_state
        else:
            new_state, outs, _ = program(state, x, y, mask, weights, drop,
                                         c_clients, hp)
        metrics = {
            "train_loss": torch.sum(outs.loss * weights) / torch.sum(weights),
            "total_steps": torch.sum(outs.num_steps),
        }
        old, new = state.global_params, new_state.global_params
        if obs:
            # modeled payload of merge + broadcast at this precision (fp32
            # reports its dense payload, so the ratios stay meaningful)
            n = param_count(old)
            cbytes = 2.0 * blockscale.collective_payload_nbytes(
                n, collective_precision, quant_block)
            metrics["obs"] = round_obs(
                old, new, real_steps=metrics["total_steps"],
                real_clients=torch.sum((weights > 0).to(torch.float32)),
                batch=int(x.shape[2]), feat=math.prod(x.shape[3:]),
                opt_flops_per_param=opt_flops, collective_bytes=cbytes,
                quant_error=qerr, n_params=n)
        if health:
            metrics["health"] = federated.client_health_stats(
                old, outs.params, param_delta(new, old), outs.loss, weights)
        return new_state, metrics, outs.new_client_state

    return core


def make_round_fn(trainer: LocalTrainer, server_opt: ServerOptimizer,
                  mode: str = "scan", **quant) -> Callable:
    """``round_fn(state, x, y, mask, weights, generator, c_clients=None,
    hp=None, noise=None) -> (new_state, metrics, new_client_state)``.
    ``c_clients`` holds the cohort's per-client state rows
    (SCAFFOLD/FedDyn; ``None`` otherwise) and ``new_client_state`` their updated rows; the stacked
    client params are not returned.  ``metrics`` holds device scalars
    (``train_loss``: the weight-averaged client loss, ``total_steps``: the
    real steps taken), read by the caller only when it logs.  ``quant``:
    :func:`make_round_core`'s quantization arguments; ``noise`` defaults
    to :func:`noise_source` of ``generator``."""
    core = make_round_core(trainer, server_opt, mode, **quant)
    model = trainer.model

    def round_fn(state: ServerState, x, y, mask, weights,
                 generator: torch.Generator, c_clients=None, hp=None,
                 noise=None):
        drop = draw_dropout(model, generator, x.shape[:3])
        return core(state, x, y, mask, weights, drop, c_clients, hp,
                    noise or noise_source(generator))

    return round_fn


def make_gather_core(trainer: LocalTrainer, server_opt: ServerOptimizer,
                     train_x: torch.Tensor, train_y: torch.Tensor,
                     mode: str = "vmap", **quant) -> Callable:
    """:func:`make_round_core` over the device-resident dataset: ``core(
    state, idx, mask, weights, drop, c_clients=None, hp=None, noise=None)``
    with the ``(C, S, B)`` index tensor in place of the data."""
    inner = make_round_core(trainer, server_opt, mode, **quant)

    def core(state: ServerState, idx, mask, weights, drop, c_clients=None,
             hp=None, noise=None):
        idx = idx.to(torch.long)
        return inner(state, train_x[idx], train_y[idx], mask, weights, drop,
                     c_clients, hp, noise)

    return core


def make_gather_round_fn(trainer: LocalTrainer, server_opt: ServerOptimizer,
                         train_x: torch.Tensor, train_y: torch.Tensor,
                         mode: str = "vmap", **quant) -> Callable:
    """Device-gather variant: the dataset lives on the device once and the
    round takes only the ``(C, S, B)`` index tensor from the host."""
    core = make_gather_core(trainer, server_opt, train_x, train_y, mode,
                            **quant)
    model = trainer.model

    def round_fn(state: ServerState, idx, mask, weights, generator,
                 c_clients=None, hp=None, noise=None):
        drop = draw_dropout(model, generator, idx.shape[:3])
        return core(state, idx, mask, weights, drop, c_clients, hp,
                    noise or noise_source(generator))

    return round_fn


# -- populations -------------------------------------------------------------
# The round is a pure function of (state, cohort, hp), so torch.func.vmap
# over the member axis of (state, client-table rows, hp) runs P experiments
# in one program: members share the cohort tensors; their dropout masks
# are drawn per member before the map.  Metrics come back (P,).

def make_population_core(core: Callable, has_table: bool) -> Callable:
    """``pop_core(states, idx, mask, w, drop, c_stacked, hps)``: ``core``
    (a gather core) mapped over the member axis of the stacked state, the
    masks ``drop`` ``(P, C, S, B, ...)``, the table rows ``c_stacked``
    ``(P, C, ...)`` and the swept fields of ``hps``."""

    def pop_core(states: ServerState, idx, mask, w, drop, c_stacked,
                 hps: federated.HParams):
        ri = states.round_idx

        def one(fields, d, c, hp):
            st = ServerState(round_idx=ri, **fields)
            new, metrics, new_c = core(st, idx, mask, w, d, c,
                                       federated.HParams(**hp))
            out = (state_fields(new), metrics)
            return out + (new_c,) if has_table else out

        hp = {k: v for k, v in hps.swept().items() if k != "seed"}
        res = torch.func.vmap(one, in_dims=(
            0, None if drop is None else 0, 0 if has_table else None, 0))(
            state_fields(states), drop, c_stacked, hp)
        new_c = res[2] if has_table else None
        return ServerState(round_idx=ri + 1, **res[0]), res[1], new_c

    return pop_core


def make_population_round_fn(trainer: LocalTrainer,
                             server_opt: ServerOptimizer,
                             train_x: torch.Tensor, train_y: torch.Tensor,
                             population, mode: str = "vmap",
                             obs: bool = False) -> Callable:
    """``pop_fn(states, idx, mask, w, generator, c_stacked, hps,
    noise=None)``: the gather round mapped over the member axis of
    ``states`` / ``c_stacked`` / ``hps``; the cohort inputs are shared
    (``noise`` is unused: a population runs fp32 collectives).  ``obs``:
    each member's ObsCarry row, ``(P,)`` leaves."""
    core = make_population_core(
        make_gather_core(trainer, server_opt, train_x, train_y, mode,
                         obs=obs),
        server_opt.spec.client_state)
    model = trainer.model

    def pop_fn(states, idx, mask, w, generator, c_stacked, hps, noise=None):
        drop = draw_member_dropout(model, generator, idx.shape[:3],
                                   population)
        return core(states, idx, mask, w, drop, c_stacked, hps)

    return pop_fn


# -- fused round blocks ------------------------------------------------------

class BlockRoundFn:
    """K rounds as one block: ``block_fn(state, idx_blk, mask_blk, w_blk,
    gens, cohort_blk, client_table=None, hp=None, round_steps=None) ->
    (state, metrics, client_table)``.

    Every cohort input gains a leading round axis of length K (``idx_blk``
    ``(K, C, S, B)``, the steps padded to the block's pow2 class);
    ``gens`` holds the K rounds' generators; ``cohort_blk`` ``(K, C)``
    (int64, every id in range: the caller checks them on the host) indexes
    the per-client state table.  ``round_steps[j]`` is round j's own pow2
    step class: the round runs at that size (its arrays sliced, its
    dropout masks drawn at it), as the unfused round does, so a block
    equals its rounds run one by one and does no work on the block's
    padding.  Metrics stack on a last ``(K,)`` axis.

    On the CPU the block is a plain loop over the rounds.  On the card the
    round is captured as a CUDA graph per (step class, cohort size), after
    one warm run on a side stream, with one memory pool shared by every
    graph of the block function, and replayed once per round.  The graph
    reads static input buffers (state, indices, mask, weights, masks,
    cohort ids), ends by copying the new state and table rows back into
    them and its metrics (loss and steps; with obs and health on, the
    ObsCarry row and the ``(C,)`` health lanes too) into one static f32
    output, which the host copies into slot j of the block's metrics;
    nothing syncs the host inside a block.  Top-level metrics stack on a
    last ``(K,)`` axis, the ``obs``/``health`` fields on a leading one.
    A capture that fails raises: there is no eager fallback."""

    def __init__(self, core: Callable, model, has_table: bool,
                 population=None):
        self.core = core
        self.model = model
        self.has_table = has_table
        self.population = population
        self.row_axis = 1 if population is not None else 0
        self._slots = {}
        self._pool = None
        self._static = None
        #: graphs captured so far (one per step class and cohort size)
        self.captures = 0

    def release(self) -> None:
        """Drop the captured graphs, their pool and static buffers (the
        next call captures anew).  On the mesh a graph holds the NCCL
        communicator it captured collectives of, which cannot be
        destroyed while the graph lives."""
        self._slots = {}
        self._pool = None
        self._static = None

    # -- shared pieces -------------------------------------------------------
    def _draw(self, gen, lead):
        if self.population is not None:
            return draw_member_dropout(self.model, gen, lead,
                                       self.population)
        return draw_dropout(self.model, gen, lead)

    def _round(self, state, idx, mask, w, drop, cohort, table, hp,
               inplace: bool):
        c = None
        ax = self.row_axis
        if self.has_table:
            c = {k: t.index_select(ax, cohort) for k, t in table.items()}
        state, metrics, new_c = self.core(state, idx, mask, w, drop, c, hp)
        if self.has_table:
            if inplace:
                for k, t in table.items():
                    t.index_copy_(ax, cohort, new_c[k].to(t.dtype))
            else:
                table = {k: t.index_copy(ax, cohort, new_c[k].to(t.dtype))
                         for k, t in table.items()}
        return state, metrics, table

    def __call__(self, state: ServerState, idx_blk, mask_blk, w_blk, gens,
                 cohort_blk, client_table=None, hp=None, round_steps=None):
        k, c, s, b = idx_blk.shape
        round_steps = list(round_steps or [s] * k)
        if idx_blk.device.type == "cuda":
            return self._replay(state, idx_blk, mask_blk, w_blk, gens,
                                cohort_blk, client_table, hp, round_steps)
        metrics = []
        table = client_table
        for j, sj in enumerate(round_steps):
            state, m, table = self._round(
                state, idx_blk[j, :, :sj], mask_blk[j, :, :sj], w_blk[j],
                self._draw(gens[j], (c, sj, b)), cohort_blk[j], table, hp,
                inplace=False)
            metrics.append(m)
        return state, stack_round_metrics(metrics), table

    # -- the card: CUDA graphs -----------------------------------------------
    def _bind(self, state, table):
        """The static state and table buffers every graph reads and
        writes, holding ``state`` and ``table`` (copied in unless they are
        those buffers already)."""
        fields = state_fields(state)
        if self._static is None:
            self._static = types.SimpleNamespace(
                fields={f: _clone(d) for f, d in fields.items()},
                table=None if table is None else _clone(table))
            return self._static
        st = self._static
        for f, d in fields.items():
            _copy_into(st.fields[f], d)
        if table is not None:
            _copy_into(st.table, table)
        return st

    def _capture(self, slots, round_idx, hp):
        """Warm the round up once on a side stream, then capture it."""
        st = self._static

        def body(copy_back):
            state = ServerState(round_idx=round_idx, **st.fields)
            new, m, _ = self._round(state, slots.idx, slots.mask, slots.w,
                                    slots.drop, slots.cohort, st.table, hp,
                                    inplace=copy_back)
            out, slots.layout = flatten_metrics(m)
            if copy_back:
                for f, d in state_fields(new).items():
                    _copy_into(st.fields[f], d)
                slots.out.copy_(out)
            return out

        t0 = time.perf_counter()
        dev = slots.idx.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out = body(False)
        torch.cuda.current_stream(dev).wait_stream(side)
        slots.out = torch.empty_like(out)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # other threads (the stager's worker) run on during the capture:
        # only this thread's calls may break it ("thread_local"), and no
        # garbage collection may free CUDA objects inside it
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                body(True)
        finally:
            gc.enable()
        self.captures += 1
        torchhooks.note_capture(time.perf_counter() - t0)
        return graph

    def _replay(self, state, idx_blk, mask_blk, w_blk, gens, cohort_blk,
                table, hp, round_steps):
        k, c, _, b = idx_blk.shape
        st = self._bind(state, table)
        out = None
        for j, sj in enumerate(round_steps):
            drop = self._draw(gens[j], (c, sj, b))
            key = (sj, c)
            slots = self._slots.get(key)
            if slots is None:
                slots = self._slots[key] = types.SimpleNamespace(
                    idx=torch.empty_like(idx_blk[j, :, :sj]),
                    mask=torch.empty_like(mask_blk[j, :, :sj]),
                    w=torch.empty_like(w_blk[j]),
                    cohort=torch.empty_like(cohort_blk[j]),
                    drop=None if drop is None else
                    tuple(torch.empty_like(d) for d in drop), out=None,
                    graph=None, layout=None)
            slots.idx.copy_(idx_blk[j, :, :sj])
            slots.mask.copy_(mask_blk[j, :, :sj])
            slots.w.copy_(w_blk[j])
            slots.cohort.copy_(cohort_blk[j])
            for buf, d in zip(slots.drop or (), drop or ()):
                buf.copy_(d)
            if slots.graph is None:
                slots.graph = self._capture(slots, state.round_idx, hp)
            slots.graph.replay()
            if out is None:
                out = torch.empty((k,) + tuple(slots.out.shape),
                                  dtype=slots.out.dtype, device=idx_blk.device)
            out[j].copy_(slots.out)
        new_state = ServerState(round_idx=state.round_idx + k, **st.fields)
        return new_state, unflatten_metrics(out, slots.layout), st.table


def _metric_items(metrics):
    """``(path, tensor)`` of a round's metrics: a top-level entry's path is
    ``(key,)``, a nested dict's (``obs``, ``health``) ``(key, field)``."""
    for key, v in metrics.items():
        if isinstance(v, dict):
            for sub, t in v.items():
                yield (key, sub), t
        else:
            yield (key,), v


def flatten_metrics(metrics):
    """A round's metrics as one f32 vector (the captured graph's static
    output) and its layout, ``[(path, shape), ...]``."""
    items = list(_metric_items(metrics))
    out = torch.cat([t.to(torch.float32).reshape(-1) for _, t in items])
    return out, [(path, tuple(t.shape)) for path, t in items]


def _nest(entries):
    metrics = {}
    for path, v in entries:
        if len(path) == 1:
            metrics[path[0]] = v
        else:
            metrics.setdefault(path[0], {})[path[1]] = v
    return metrics


def stack_round_metrics(per_round):
    """Stack K rounds' metrics dicts as a block returns them: a top-level
    entry on a last ``(K,)`` axis (``(P, K)`` with a population), an obs
    or health field on a leading one (``(K,)``, ``(K, 4)``, ``(K, C)``)."""
    paths = [p for p, _ in _metric_items(per_round[0])]
    cols = zip(*[[t for _, t in _metric_items(m)] for m in per_round])
    return _nest((p, torch.stack(list(c), dim=-1 if len(p) == 1 else 0))
                 for p, c in zip(paths, cols))


def unflatten_metrics(out, layout):
    """The ``(K, L)`` outputs of K replayed rounds (:func:`flatten_metrics`'
    vectors) back into :func:`stack_round_metrics`' form."""
    rounds = []
    for row in out:
        lo, entries = 0, []
        for path, shape in layout:
            n = math.prod(shape)
            entries.append((path, row[lo:lo + n].reshape(shape)))
            lo += n
        rounds.append(_nest(entries))
    return stack_round_metrics(rounds)


def _clone(d):
    """A copy of a state field or table: a ``{name: tensor}`` dict or one
    tensor."""
    if isinstance(d, torch.Tensor):
        return d.clone()
    return {k: v.clone() for k, v in d.items()}


def _copy_into(dst, src) -> None:
    """Copy ``src`` into the static buffers ``dst`` (same structure),
    skipping a buffer that already is the source."""
    if isinstance(dst, torch.Tensor):
        if dst is not src:
            dst.copy_(src)
        return
    for k, v in src.items():
        if dst[k] is not v:
            dst[k].copy_(v)


def make_block_round_fn(trainer: LocalTrainer, server_opt: ServerOptimizer,
                        train_x: torch.Tensor, train_y: torch.Tensor,
                        mode: str = "vmap", population=None,
                        obs: bool = False, health: bool = False
                        ) -> BlockRoundFn:
    """The fused round block (:class:`BlockRoundFn`) over the
    device-resident dataset; with a ``population`` the block of the
    population round (metrics ``(P, K)``, the table ``(P, rows, ...)``).
    ``obs``/``health``: the rounds' ObsCarry rows and health lanes, stacked
    ``(K,)`` / ``(K, C)`` (:func:`make_round_core`)."""
    core = make_gather_core(trainer, server_opt, train_x, train_y, mode,
                            obs=obs, health=health)
    has_table = server_opt.spec.client_state
    if population is not None:
        core = make_population_core(core, has_table)
    return BlockRoundFn(core, trainer.model, has_table, population)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# -- cohort bucketing --------------------------------------------------------

#: server-optimizer families whose round aggregates are plain weighted
#: averages and carry no per-client state, so bucket partials merge exactly
#: (SCAFFOLD/FedDyn keep per-client trees, FedNova/Mime aux terms don't
#: merge across padded buckets: those stay on the single-cohort path)
BUCKETABLE_ALGS = ("fedavg", "fedavg_seq", "fedprox", "fedopt", "fedopt_seq")


def make_bucket_agg_fn(trainer: LocalTrainer, server_opt: ServerOptimizer,
                       mode: str = "vmap",
                       train_x: Optional[torch.Tensor] = None,
                       train_y: Optional[torch.Tensor] = None) -> Callable:
    """Partial-round program for bucketed cohorts (ragged client sizes).

    The single-cohort round pads every client to the cohort's max step
    count, so under a skewed split most of the cohort runs masked steps.
    Bucketing groups clients by pow2 step class and runs this program once
    per bucket; the aggregates are weighted averages, so bucket partials
    merge exactly (``ServerOptimizer.merge_aggregates``) before one
    ``update_from_aggregates``: the same math, less padding.

    Returns ``bucket_fn(state, x, y, mask, weights, drop) -> (agg, total_w,
    loss_w, total_steps)``; with ``train_x``/``train_y`` (the
    device-resident dataset) ``bucket_fn(state, idx, mask, weights, drop)``
    takes the ``(C, S, B)`` index tensor in place of ``x, y``.  Padded
    client rows must carry weight 0."""
    if server_opt.algorithm not in BUCKETABLE_ALGS:
        raise ValueError(
            f"cohort bucketing supports {BUCKETABLE_ALGS}; "
            f"{server_opt.algorithm!r} keeps aux state whose aggregates "
            "don't merge across padded buckets")
    program = federated.RoundProgram(server_opt.spec,
                                     trainer.make_local_train(), server_opt,
                                     mode)

    def bucket_fn(state: ServerState, x, y, mask, weights, drop=None):
        outs = program.run_clients(state, x, y, mask, drop, None)
        agg = server_opt.compute_aggregates(state, outs.params, weights, {})
        return (agg, torch.sum(weights), torch.sum(outs.loss * weights),
                torch.sum(outs.num_steps))

    if train_x is None:
        return bucket_fn

    def gather_bucket_fn(state: ServerState, idx, mask, weights, drop=None):
        idx = idx.to(torch.long)
        return bucket_fn(state, train_x[idx], train_y[idx], mask, weights,
                         drop)

    return gather_bucket_fn
