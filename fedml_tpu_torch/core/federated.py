"""Federated round algebra (port of ``fedml_tpu.core.federated``): the
placement primitives, the reducers (stacked for the sp engine, all-reduce
and reduce-scatter for the mesh), the :class:`AlgorithmSpec`
registry of the algorithm zoo and the :class:`RoundProgram` that composes
them.  A round reads ``broadcast -> client_map -> weighted reductions ->
server update``; which reductions an algorithm needs beyond the weighted
params average (SCAFFOLD's Δc, FedNova's τ, ...) is declared in its spec.

Every spec function and server transition takes an optional
:class:`HParams` (``hp``): a population of P experiments stacks its swept
fields on a leading member axis and maps the round over it with
``torch.func.vmap``; ``hp=None`` reads the static values, bitwise the
single-experiment path.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import rng as rng_util
from . import tree as tree_util


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------

def broadcast(tree):
    """Server -> clients placement: the identity on one device, kept as the
    composition point a round program reads from."""
    return tree


def client_map(fn: Callable, mode: str = "vmap") -> Callable:
    """Map a pure per-client fn over cohort-stacked inputs (leading client
    axis; ``None`` arguments are shared).  ``vmap`` batches the clients
    through ``torch.func.vmap``; ``scan`` runs them one after another and
    stacks their outputs.  ``vmap:k`` batches them ``k`` at a time, in
    order, the last group filled to ``k`` with copies of its last client
    (their outputs dropped): every group runs at the width ``k``, as each
    rank of a mesh of ``ceil(C / k)`` ranks runs its block of the padded
    cohort, so the sp engine can run a mesh's client map on one device."""
    width = None
    if mode.startswith("vmap:"):
        width = int(mode[len("vmap:"):])
        if width < 1:
            raise ValueError(f"client_map width must be >= 1, got {mode!r}")
    elif mode not in ("vmap", "scan"):
        raise ValueError(
            f"client_map mode must be 'vmap'|'vmap:<k>'|'scan', got {mode!r}")

    def vmapped(*args):
        dims = tuple(None if a is None else 0 for a in args)
        return torch.func.vmap(fn, in_dims=dims,
                               randomness="different")(*args)

    def mapped(*args):
        if mode == "vmap":
            return vmapped(*args)
        n = _lead(next(a for a in args if a is not None))
        if width is not None:
            outs = []
            for lo in range(0, n, width):
                rows = torch.arange(lo, lo + width).clamp_max(n - 1)
                got = vmapped(*(_take(a, rows) for a in args))
                outs.append(_take(got, torch.arange(min(width, n - lo))))
            return _cat(outs)
        outs = [fn(*(_index(a, i) for a in args)) for i in range(n)]
        return _stack(outs)

    return mapped


def _take(a, rows):
    if a is None:
        return None
    if isinstance(a, tuple):
        return tuple(_take(x, rows) for x in a)
    if isinstance(a, dict):
        return {k: _take(v, rows) for k, v in a.items()}
    return a[rows.to(a.device)]


def _cat(outs):
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return tuple(_cat([o[j] for o in outs]) for j in range(len(first)))
    if isinstance(first, dict):
        return {k: _cat([o[k] for o in outs]) for k in first}
    return torch.cat(outs)


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
        return tuple(_index(x, i) for x in a)
    if isinstance(a, dict):
        return {k: _index(v, i) for k, v in a.items()}
    return a[i]


def _stack(outs):
    first = outs[0]
    if isinstance(first, tuple):
        return tuple(_stack([o[j] for o in outs]) for j in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    return torch.stack(outs)


def weighted_reduce(stacked, weights):
    """Clients -> server placement: weighted average over the leading
    client axis, in f32."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    den = torch.sum(w)
    return tree_util.tree_map(
        lambda l: torch.tensordot(w, l.to(torch.float32), dims=1) / den,
        stacked)


class StackedReducer:
    """sp engine: the cohort is one stacked tree on this device."""

    def wavg(self, stacked, w):
        return tree_util.stacked_weighted_average(stacked, w)

    def wavg_scalar(self, vec, w):
        p = w / torch.sum(w)
        return torch.sum(p * vec)

    def sum_scalar(self, vec):
        return torch.sum(vec)


class PartialReducer:
    """Silo tier of the two-tier aggregation: every weighted reduction
    returns its unfinished ``{"num", "den"}`` pair, so the partials of
    several silos combine exactly at the server
    (:func:`combine_partial_aggregates`: ``sum(nums) / sum(dens)`` is the
    cohort average up to float reassociation); ``sum``-kind aggregates are
    associative and stay plain."""

    def wavg(self, stacked, w):
        w = torch.as_tensor(w, dtype=torch.float32)
        return {"num": weighted_sums(stacked, w), "den": torch.sum(w)}

    def wavg_scalar(self, vec, w):
        return {"num": torch.sum(w * vec), "den": torch.sum(w)}

    def sum_scalar(self, vec):
        return torch.sum(vec)


def combine_partial_aggregates(spec: "AlgorithmSpec", partials
                               ) -> Dict[str, Any]:
    """Server tier: combine the silos' partial-aggregate dicts (each built
    by :func:`build_aggregates` with a :class:`PartialReducer`) into the
    finished aggregate dict ``ServerOptimizer.update_from_aggregates``
    reads."""

    def finish(key):
        den = sum(p[key]["den"] for p in partials)
        num = _tmap(lambda *ls: sum(ls), *[p[key]["num"] for p in partials])
        return _tmap(lambda l: l / den, num)

    agg: Dict[str, Any] = {
        "n_sampled": sum(p["n_sampled"] for p in partials)}
    if spec.avg_params:
        agg["avg_params"] = finish("avg_params")
    for a in spec.aggregates:
        if a.kind in ("wavg", "scalar"):
            agg[a.name] = finish(a.name)
        else:  # sum: already associative
            agg[a.name] = sum(p[a.name] for p in partials)
    return agg


def weighted_sums(stacked, w):
    """Per-leaf f32 ``Σ_i w_i · leaf_i`` over the leading client axis."""
    w = w.to(torch.float32)
    return tree_util.tree_map(
        lambda l: torch.tensordot(w, l.to(torch.float32), dims=1), stacked)


class PsumReducer:
    """Mesh replicated merge over the client axis (``mesh``: a
    :class:`~fedml_tpu_torch.core.mesh.Mesh`): the weights are all-reduced
    first, then each rank's partial sum of its clients weighted by their
    share of the total, then one all-reduce.  That is the sp engine's
    order (:class:`StackedReducer` normalises the weights, then sums), so
    a world of 1 merges bitwise as the sp engine does; a CNN's rounds
    amplify a last-bit difference in the merge chaotically (to ~3e-3 in
    one FEMNIST round on the card), and the mesh ≡ sp check stays exact.
    A tree's leaves travel as one flat vector: one collective for the
    weight, one for the numerators."""

    def __init__(self, mesh, axis=None):
        self.mesh = mesh
        #: the ranks the cohort spreads over (None: every rank; the
        #: client groups on the 3-D pipeline layout, whose leaves are
        #: each rank's shards)
        self.axis = axis

    def wavg(self, stacked, w):
        num = weighted_sums(stacked, w / self.mesh.psum(torch.sum(w),
                                                        self.axis))
        return dict(zip(num, self.mesh.psum_many(list(num.values()),
                                                 self.axis)))

    def wavg_scalar(self, vec, w):
        p = w / self.mesh.psum(torch.sum(w), self.axis)
        return self.mesh.psum(torch.sum(p * vec), self.axis)

    def sum_scalar(self, vec):
        return self.mesh.psum(torch.sum(vec), self.axis)


class Psum2DReducer:
    """The replicated merge on a 2-D ``client × model`` mesh
    (``layout``: a :class:`~fedml_tpu_torch.simulation.mesh.layout.
    MeshLayout`): each leaf's weighted numerator over this rank's clients
    is reduce-scattered over the model group (whole leaves all-reduced),
    and that ``1/m`` shard all-reduced over the client group, so each rank
    receives its model shard of the cohort's sum.  Weighted in the sp
    engine's order, as :class:`PsumReducer`; scalars all-reduce over every
    rank."""

    def __init__(self, layout):
        self.layout = layout
        self.mesh = layout.mesh

    def wavg(self, stacked, w):
        num = self.layout.reduce_tree(
            weighted_sums(stacked, w / self.mesh.psum(torch.sum(w))))
        return dict(zip(num, self.mesh.psum_many(list(num.values()),
                                                 axis="client")))

    def wavg_scalar(self, vec, w):
        p = w / self.mesh.psum(torch.sum(w))
        return self.mesh.psum(torch.sum(p * vec))

    def sum_scalar(self, vec):
        return self.mesh.psum(torch.sum(vec))


class ScatterReducer:
    """Mesh scatter merge (arXiv:2004.13336): a tree aggregate flattens
    into one padded vector (``flat_spec``) and reduce-scatters, so each
    shard receives only its contiguous chunk; scalars still all-reduce.
    Weighted in the sp engine's order, as :class:`PsumReducer`.  On the
    3-D pipeline layout the weights and scalars reduce over ``axis`` (the
    client groups) and ``place`` turns this rank's leaf shards into whole
    leaves, zero off its shard, so the reduce-scatter over every rank sums
    each entry once per client shard."""

    def __init__(self, flat_spec, mesh, axis=None, place=None):
        self.flat = flat_spec
        self.mesh = mesh
        self.axis = axis
        self.place = place or (lambda tree: tree)

    def wavg(self, stacked, w):
        p = w / self.mesh.psum(torch.sum(w), self.axis)
        return self.mesh.psum_scatter(
            self.flat.flatten(self.place(weighted_sums(stacked, p))))

    def wavg_scalar(self, vec, w):
        p = w / self.mesh.psum(torch.sum(w), self.axis)
        return self.mesh.psum(torch.sum(p * vec), self.axis)

    def sum_scalar(self, vec):
        return self.mesh.psum(torch.sum(vec), self.axis)


# --------------------------------------------------------------------------
# swept hyperparameters
# --------------------------------------------------------------------------

#: HParams fields a population may sweep (``population_axes`` keys)
HPARAM_FIELDS = ("server_lr", "client_lr", "prox_mu", "feddyn_alpha",
                 "qfed_q", "seed")


@dataclass(frozen=True)
class HParams:
    """Knobs of one federated experiment that a population sweeps.

    Every field is optional: ``None`` means "use the static value from
    args" and keeps the default path's numerics bitwise the same.  A
    population stacks each swept field to a ``(P,)`` tensor and maps the
    round over it with ``torch.func.vmap``; inside the map each field is
    the member's 0-d value.

    ``seed`` never enters the mapped round: the member's dropout masks are
    drawn from :func:`fold_seed`'s generator before the map."""
    server_lr: Any = None
    client_lr: Any = None
    prox_mu: Any = None
    feddyn_alpha: Any = None
    qfed_q: Any = None
    seed: Any = None

    def swept(self) -> Dict[str, Any]:
        """The set fields, as a dict (what ``vmap`` maps over)."""
        return {f: getattr(self, f) for f in HPARAM_FIELDS
                if getattr(self, f) is not None}


def resolve(hp: Optional[HParams], name: str, static):
    """The swept value when ``hp`` carries one, else the static default.
    With ``hp=None`` this returns the Python float unchanged, so the
    single-experiment path is bitwise the historical one."""
    if hp is None:
        return static
    v = getattr(hp, name, None)
    return static if v is None else v


def lr_ratio(hp: Optional[HParams], name: str, static_lr: float):
    """Multiplier turning an update computed at the static learning rate
    into one at the swept rate.  Every optimizer here ends in ``-lr·u``, so
    updates are linear in lr and post-scaling by ``swept/static`` is exact
    up to one rounding; ``None`` (not swept) means "multiply by nothing":
    the caller skips the scale and the default path stays bitwise."""
    if hp is None:
        return None
    v = getattr(hp, name, None)
    if v is None:
        return None
    if static_lr == 0.0:
        raise ValueError(
            f"sweeping {name} requires a nonzero static {name} baseline "
            "(the swept rate applies as a ratio to the static optimizer)")
    return v / static_lr


#: high word of the child-seed word :func:`fold_seed` derives a member's
#: generator with, so member streams never coincide with per-client ones
SEED_FOLD_TAG = 0x5EED


def fold_seed(gen: torch.Generator, hp: Optional[HParams]
              ) -> torch.Generator:
    """The member's generator of a round: a child of the round's generator
    keyed by the member's seed when the population sweeps one (never the
    same stream for every member), else ``gen`` itself (members share the
    round's draws, so the sweep isolates the hyperparameter)."""
    if hp is None or getattr(hp, "seed", None) is None:
        return gen
    seed = int(hp.seed) & 0xFFFFFFFF
    return rng_util.child_key(gen, (SEED_FOLD_TAG << 32) | seed)


# --------------------------------------------------------------------------
# algorithm specs
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class AggSpec:
    """One cross-client aggregate of a round.

    ``source(opt, state, outs, hp)`` returns the per-client stacked tree
    (``kind="wavg"``) or ``(C,)`` vector (scalar kinds); ``weights(opt,
    outs, w, hp)`` the per-client weights.  ``kind``: ``wavg`` (weighted
    average of a stacked tree), ``scalar`` (weighted average of a scalar
    per client) or ``sum`` (sum of ``source * weights``)."""
    name: str
    source: Callable
    weights: Callable = lambda opt, outs, w, hp: w
    kind: str = "wavg"


def _real(opt, outs, w, hp=None):
    """Real-client mask: padded zero-weight cohort rows contribute
    nothing."""
    return (w > 0).to(torch.float32)


def _nova_deltas(opt, state, outs, hp):
    """FedNova normalised directions d_i = (x - y_i)/max(tau_i, 1)."""
    tau = outs.tau
    return tree_util.tree_map(
        lambda yi, gx: (gx[None] - yi) / torch.clamp(
            tau.reshape((-1,) + (1,) * (yi.dim() - 1)), min=1.0),
        outs.params, state.global_params)


@dataclass(frozen=True)
class AlgorithmSpec:
    """Declarative round shape of one federated optimizer: the
    cross-client reductions beyond the universal ``avg_params`` /
    ``n_sampled`` pair, whether it keeps per-client state, and (optional)
    a pure server transition ``update(gvals, agg, hp, opt) -> (new_gvals,
    new_fields)`` used in place of the ``ServerOptimizer`` built-ins."""
    name: str
    aggregates: Tuple[AggSpec, ...] = ()
    avg_params: bool = True
    client_state: bool = False
    update: Optional[Callable] = None


_SPECS: Dict[str, AlgorithmSpec] = {}


def register_algorithm(spec: AlgorithmSpec) -> AlgorithmSpec:
    """Add an algorithm to the registry (``federated_optimizer: <name>``
    then runs it); re-registering a name replaces the spec."""
    _SPECS[spec.name] = spec
    return spec


def get_spec(name: str) -> AlgorithmSpec:
    try:
        return _SPECS[name.lower()]
    except KeyError:
        raise KeyError(f"no AlgorithmSpec registered for {name!r} "
                       f"(known: {sorted(_SPECS)})") from None


def has_spec(name: str) -> bool:
    return name.lower() in _SPECS


# -- the built-in zoo as specs ----------------------------------------------

for _name in ("fedavg", "fedavg_seq", "fedprox", "fedopt", "fedopt_seq",
              "feddyn"):
    register_algorithm(AlgorithmSpec(_name, client_state=_name == "feddyn"))

register_algorithm(AlgorithmSpec(
    "scaffold",
    aggregates=(AggSpec("mean_delta_c",
                        source=lambda opt, state, outs, hp: outs.delta_c,
                        weights=_real),),
    client_state=True))

register_algorithm(AlgorithmSpec(
    "fednova",
    aggregates=(AggSpec("nova_d", source=_nova_deltas),
                AggSpec("tau_eff",
                        source=lambda opt, state, outs, hp: outs.tau,
                        kind="scalar"))))

for _name in ("mime", "fedsgd"):
    register_algorithm(AlgorithmSpec(
        _name, aggregates=(AggSpec(
            "avg_grad",
            source=lambda opt, state, outs, hp: outs.grad_sum),)))

# buffered-async FedAvg: the round shape is FedAvg's; it names the
# buffered-async engine (simulation/async_engine.py), which runs the spec of
# ``async_base_optimizer`` over its buffer
register_algorithm(AlgorithmSpec("fedbuff"))


# -- q-FedAvg (arXiv:1905.10497): fair aggregation as a pure spec -----------

def _qfed_q(opt, hp):
    return resolve(hp, "qfed_q", opt.qfed_q)


def _qfed_deltas(opt, state, outs, hp):
    L = 1.0 / opt.qfed_lr
    return tree_util.tree_map(lambda yi, gx: (gx[None] - yi) * L,
                              outs.params, state.global_params)


def _qfed_u(opt, state, outs, hp):      # F_k^q
    return torch.pow(torch.clamp(outs.loss, min=1e-10), _qfed_q(opt, hp))


def _qfed_h(opt, state, outs, hp):      # q F^{q-1} ||Δ||^2 + L F^q
    L = 1.0 / opt.qfed_lr
    q = _qfed_q(opt, hp)
    F = torch.clamp(outs.loss, min=1e-10)
    dn = sum(torch.sum((((gx[None] - yi) * L).to(torch.float32)) ** 2,
                       dim=tuple(range(1, yi.dim())))
             for yi, gx in zip(outs.params.values(),
                               state.global_params.values()))
    return q * torch.pow(F, q - 1.0) * dn + L * torch.pow(F, q)


def _qfed_update(gvals, agg, hp, opt):
    scale = agg["qfed_u"] / torch.clamp(agg["qfed_h"], min=1e-12)
    new = tree_util.tree_map(lambda g, d: g - scale * d, gvals,
                             agg["qfed_delta"])
    return new, {}


QFEDAVG = register_algorithm(AlgorithmSpec(
    "qfedavg", avg_params=False, update=_qfed_update,
    aggregates=(
        AggSpec("qfed_delta", source=_qfed_deltas,
                weights=lambda opt, outs, w, hp:
                _real(opt, outs, w) * _qfed_u(opt, None, outs, hp)),
        AggSpec("qfed_u", source=_qfed_u, weights=_real, kind="sum"),
        AggSpec("qfed_h", source=_qfed_h, weights=_real, kind="sum"),
    )))


def check_algorithm(name: str) -> str:
    """Lower-cased ``name`` if the port runs it (every registered
    algorithm); raises otherwise, naming the algorithm."""
    name = name.lower()
    runnable = sorted(_SPECS)
    if name not in _SPECS:
        raise ValueError(f"unknown federated_optimizer {name!r} "
                         f"(the port runs {runnable})")
    return name


# --------------------------------------------------------------------------
# buffered-async aggregation (FedBuff, arXiv:2106.06639)
# --------------------------------------------------------------------------
# - :func:`client_update_rows` evaluates the spec's per-client sources at
#   DISPATCH, unreduced, so a buffer can weight each row by its staleness
#   when it lands;
# - :func:`update_buffer_add` lands arrivals in a K-row buffer at host-given
#   slots (slot K is the padding sentinel: such a lane is dropped);
# - :func:`update_buffer_apply` finishes the buffer with the sync engines'
#   own stacked reductions, so K = cohort rows landed in dispatch order
#   with zero staleness reproduce the synchronous merge;
# - :func:`scale_partial` staleness-discounts a ``{num, den}`` partial.

def _tmap(fn, *trees):
    """``fn`` over the tensors of nested dicts of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def staleness_discount(tau, alpha: float) -> torch.Tensor:
    """FedBuff's staleness discount ``s(τ) = 1/(1+τ)^α``; exactly 1 at
    ``τ = 0``, so a fresh update keeps its weight bit for bit."""
    tau = torch.as_tensor(tau, dtype=torch.float32)
    return torch.pow(1.0 + tau, -float(alpha))


def client_update_rows(spec: "AlgorithmSpec", opt, state, outs, w,
                       hp: Optional[HParams] = None) -> Dict[str, Any]:
    """Per-client unreduced aggregate rows against the dispatch-time
    ``state`` (FedNova and q-FedAvg deltas reference the params the client
    trained from): ``n_rows`` the real-client mask; a wavg or scalar
    aggregate ``{"src": stacked, "w": (C,)}``; a sum aggregate ``{"src":
    src * ww}`` (pre-weighted)."""
    rows: Dict[str, Any] = {"n_rows": _real(opt, outs, w)}
    if spec.avg_params:
        rows["avg_params"] = {"src": outs.params,
                              "w": torch.as_tensor(w, dtype=torch.float32)}
    for a in spec.aggregates:
        src = a.source(opt, state, outs, hp)
        ww = a.weights(opt, outs, w, hp)
        if a.kind in ("wavg", "scalar"):
            rows[a.name] = {"src": src, "w": ww}
        else:
            rows[a.name] = {"src": src * ww}
    return rows


def update_buffer_zeros(spec: "AlgorithmSpec", rows: Dict[str, Any],
                        k: int) -> Dict[str, Any]:
    """A zeroed ``k``-row buffer shaped like ``rows`` (leading client axis
    resized to ``k``), with the per-row discount and staleness lanes, the
    occupancy and the server model version."""
    first = next(iter(_leaves(rows)))
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                   device=first.device)
    return {
        "rows": _tmap(lambda l: torch.zeros((int(k),) + tuple(l.shape[1:]),
                                            dtype=l.dtype, device=l.device),
                      rows),
        "s": z(int(k)), "tau": z(int(k)), "occupancy": z(), "version": z(),
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def update_buffer_add(buf: Dict[str, Any], rows: Dict[str, Any],
                      idx, slots, s, tau) -> Dict[str, Any]:
    """Land arrivals in the buffer: lane j takes row ``idx[j]`` of
    ``rows`` (a generation's stacked outputs) into slot ``slots[j]`` with
    discount ``s[j]`` and staleness ``tau[j]``.  Lanes whose slot is ``K``
    (or more) are padding and dropped, as XLA drops an out-of-bounds
    scatter.  ``idx``/``slots``/``s``/``tau`` are host arrays; the buffer is
    updated in place and returned."""
    idx, slots = np.asarray(idx, np.int64), np.asarray(slots, np.int64)
    k = buf["s"].shape[0]
    keep = slots < k
    if not keep.any():
        return buf
    dev = buf["s"].device
    src = torch.as_tensor(idx[keep], device=dev)
    dst = torch.as_tensor(slots[keep], device=dev)

    def land(d, r):
        d[dst] = r.index_select(0, src).to(d.dtype)
        return d

    _tmap(land, buf["rows"], rows)
    buf["s"][dst] = torch.as_tensor(np.asarray(s, np.float32)[keep],
                                    device=dev)
    buf["tau"][dst] = torch.as_tensor(np.asarray(tau, np.float32)[keep],
                                      device=dev)
    buf["occupancy"] = buf["occupancy"] + float(keep.sum())
    return buf


def update_buffer_apply(spec: "AlgorithmSpec", opt, state, buf,
                        hp: Optional[HParams] = None):
    """Finish the buffer into one aggregate dict with the stacked
    reductions over staleness-weighted ``s_i · w_i``, and run the server
    transition.  Returns ``(new_state, agg, fresh)``, ``fresh`` the zeroed
    buffer with its version one higher."""
    s = buf["s"]
    red = StackedReducer()
    agg: Dict[str, Any] = {"n_sampled": torch.sum(s * buf["rows"]["n_rows"])}
    if spec.avg_params:
        e = buf["rows"]["avg_params"]
        agg["avg_params"] = red.wavg(e["src"], s * e["w"])
    for a in spec.aggregates:
        e = buf["rows"][a.name]
        if a.kind == "wavg":
            agg[a.name] = red.wavg(e["src"], s * e["w"])
        elif a.kind == "scalar":
            agg[a.name] = red.wavg_scalar(e["src"], s * e["w"])
        else:   # sum: the rows arrived pre-weighted
            agg[a.name] = torch.sum(s * e["src"])
    new_state = opt.update_from_aggregates(state, agg, hp)
    fresh = _tmap(torch.zeros_like, buf)
    fresh["version"] = buf["version"] + 1.0
    return new_state, agg, fresh


def scale_partial(spec: "AlgorithmSpec", partial: Dict[str, Any],
                  s) -> Dict[str, Any]:
    """Staleness-discount a partial aggregate by ``s``: every numerator and
    denominator of a ``{"num", "den"}`` entry scales (so combining the
    discounted partials gives the staleness-weighted average), as does any
    other entry."""
    s = torch.as_tensor(s, dtype=torch.float32)

    def scale_entry(v):
        if isinstance(v, dict) and set(v) == {"num", "den"}:
            return {"num": _tmap(lambda l: s * l, v["num"]),
                    "den": s * v["den"]}
        return _tmap(lambda l: s * l, v)

    return {k: scale_entry(v) for k, v in partial.items()}


def zero_like_partial(partial: Dict[str, Any]) -> Dict[str, Any]:
    """A partial aggregate that contributes nothing to
    :func:`combine_partial_aggregates`: every numerator, denominator,
    sum-kind entry and ``n_sampled`` zero, so the average over a padded
    set equals the average over the real partials alone.  Quorum rounds
    pad the arrived set to the full silo count with these."""
    return _tmap(torch.zeros_like, partial)


def wire_roundtrip_partial(partial: Dict[str, Any], wire_link,
                           link: str) -> Dict[str, Any]:
    """Quantize and dequantize one partial aggregate through the fedwire
    codec with the link's error feedback: the transform the distributed
    tier applies when it ships the partial, so the in-process
    ``HierarchicalSiloAPI`` carries the same numerics (and the same EF
    trajectory on each ``partial:<i>`` link).  The decoded tree comes back
    in ``partial``'s structure, order, devices and dtypes."""
    got = wire_link.decode(wire_link.encode(partial, link=link))
    return _tmap(lambda ref, new: torch.as_tensor(np.asarray(new)).to(
        device=ref.device, dtype=ref.dtype), partial, got)


# --------------------------------------------------------------------------
# fedmon per-client health stats
# --------------------------------------------------------------------------

#: stat lanes of the per-client health rows (FedBuff appends a
#: ``staleness`` lane at buffer-apply time)
HEALTH_STAT_FIELDS = ("update_norm", "cosine", "loss_delta", "weight")


def health_sums(old_params, client_params, ref_delta, leaf_weight=None):
    """The sums behind the health lanes: ``(‖Δ_i‖², ⟨Δ_i, ref⟩, ‖ref‖²)``
    with ``Δ_i`` client i's stacked params minus ``old_params``, over
    every leaf of the ``{name: tensor}`` dicts, in f32.  ``leaf_weight(
    name)`` scales a leaf's terms (a mesh rank whose shards of a leaf
    repeat another rank's counts them 0)."""
    f32 = torch.float32
    sq = dot = ref_sq = 0.0
    for k, op in old_params.items():
        cp = client_params[k]
        c = cp.shape[0]
        d = cp.to(f32).reshape(c, -1) - op.to(f32).reshape(1, -1)
        r = ref_delta[k].to(f32).reshape(-1)
        terms = (torch.sum(d * d, dim=1), d @ r, torch.sum(r * r))
        if leaf_weight is not None:
            wk = float(leaf_weight(k))
            terms = tuple(t * wk for t in terms)
        sq, dot, ref_sq = sq + terms[0], dot + terms[1], ref_sq + terms[2]
    return sq, dot, ref_sq


def health_lanes(sq, dot, ref_sq, loss, weights, mean_loss=None
                 ) -> Dict[str, torch.Tensor]:
    """The ``(C,)`` f32 lanes from :func:`health_sums`' sums: ``update_norm``
    ``‖Δ_i‖₂``, ``cosine`` ``cos(Δ_i, ref)`` (a label flip reads strongly
    negative), ``loss_delta`` (loss_i minus the cohort's weighted-mean loss,
    ``mean_loss`` when the caller reduced it over a mesh) and the
    real-client ``weight`` (pad rows read 0 and the host monitor drops
    them)."""
    f32 = torch.float32
    w = torch.as_tensor(weights).to(f32)
    norm = torch.sqrt(sq)
    cosine = dot / torch.clamp(norm * torch.sqrt(ref_sq), min=1e-12)
    loss = torch.as_tensor(loss).to(f32)
    if mean_loss is None:
        mean_loss = torch.sum(w * loss) / torch.clamp(torch.sum(w),
                                                      min=1e-12)
    return {"update_norm": norm, "cosine": cosine,
            "loss_delta": loss - mean_loss, "weight": w}


def client_health_stats(old_params, client_params, ref_delta, loss,
                        weights) -> Dict[str, torch.Tensor]:
    """Fixed-shape per-client health rows (the JAX package's
    ``client_health_stats``), computed on the round's device from data the
    round already holds: the stacked client params against the broadcast
    ``old_params`` and a reference direction ``ref_delta`` (the server
    update ``new − old`` on the sync engines, the generation's
    weighted-mean delta on FedBuff).  Returned through the metrics dict the
    loss rides, so nothing is read back before the round loop's own
    sync."""
    return health_lanes(*health_sums(old_params, client_params, ref_delta),
                        loss, weights)


def cohort_mean_delta(old_params, client_params, weights):
    """The weighted cohort-mean update ``Σ w_i Δ_i / Σ w_i``: FedBuff's
    reference direction, computed at dispatch before any apply."""
    w = torch.as_tensor(weights).to(torch.float32)
    den = torch.clamp(torch.sum(w), min=1e-12)
    return {k: torch.tensordot(w, client_params[k].to(torch.float32),
                               dims=1) / den - op.to(torch.float32)
            for k, op in old_params.items()}


# --------------------------------------------------------------------------
# spec-driven aggregates
# --------------------------------------------------------------------------

def build_aggregates(spec: AlgorithmSpec, red, opt, state, outs,
                     w, hp=None, include_avg: bool = True) -> Dict[str, Any]:
    """The round's cross-client reductions, built from the algorithm's
    spec with the engine's reducer (``hp``: the swept hyperparameters, or
    ``None``).  ``include_avg=False`` leaves ``avg_params`` out: the
    quantized merge builds it itself."""
    agg: Dict[str, Any] = {"n_sampled": red.sum_scalar(_real(opt, outs, w))}
    if spec.avg_params and include_avg:
        agg["avg_params"] = red.wavg(outs.params, w)
    for a in spec.aggregates:
        src = a.source(opt, state, outs, hp)
        ww = a.weights(opt, outs, w, hp)
        if a.kind == "wavg":
            agg[a.name] = red.wavg(src, ww)
        elif a.kind == "scalar":
            agg[a.name] = red.wavg_scalar(src, ww)
        else:  # sum
            agg[a.name] = red.sum_scalar(src * ww)
    return agg


@dataclass
class RoundProgram:
    """One federated round composed from the primitives::

        new_state, outs, agg = program(state, x, y, mask, weights, drop,
                                       c_clients, hp)

    ``local_train(global_params, xb, yb, mask, drop, ctx, client_state)``
    is the per-client body (:meth:`LocalTrainer.make_local_train`); ``drop``
    holds the cohort's dropout keep-masks and ``c_clients`` the cohort's
    per-client state rows (leading client axis each), or ``None``; ``hp``
    the swept :class:`HParams` or ``None``."""
    spec: AlgorithmSpec
    local_train: Callable
    server_opt: Any
    mode: str = "vmap"
    reducer: Any = field(default_factory=StackedReducer)

    def run_clients(self, state, x, y, mask, drop, c_clients, hp=None):
        from ..ml.trainer.local_trainer import ClientOut, ServerCtx
        ctx = ServerCtx(global_params=state.global_params,
                        c_server=state.c_server,
                        server_momentum=state.momentum, hparams=hp)
        g = broadcast(state.global_params)
        fn = lambda xb, yb, mb, db, cc: self.local_train(g, xb, yb, mb, db,
                                                         ctx, cc)
        return ClientOut(**client_map(fn, self.mode)(x, y, mask, drop,
                                                     c_clients))

    def __call__(self, state, x, y, mask, weights, drop=None,
                 c_clients=None, hp=None):
        outs = self.run_clients(state, x, y, mask, drop, c_clients, hp)
        agg = build_aggregates(self.spec, self.reducer, self.server_opt,
                               state, outs, weights, hp)
        new_state = self.server_opt.update_from_aggregates(state, agg, hp)
        return new_state, outs, agg


# --------------------------------------------------------------------------
# populations: P experiments in one round program
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Population:
    """A stacked batch of P experiments sharing one round program."""
    size: int
    axes: Dict[str, tuple]
    members: Tuple[Dict[str, Any], ...]   # per-member hparam dicts (host)
    hparams: HParams                      # stacked (P,) tensors

    def to(self, device) -> "Population":
        return dataclasses.replace(self, hparams=HParams(**{
            k: v.to(device) for k, v in self.hparams.swept().items()}))

    def member_hparams(self, m: int) -> HParams:
        """Member ``m``'s values, as host scalars."""
        return HParams(**self.members[m])


def parse_population(args) -> Optional[Population]:
    """``args.population`` / ``args.population_axes`` -> :class:`Population`.

    ``population_axes`` maps hparam names (:data:`HPARAM_FIELDS`) to value
    lists; the population is their cartesian grid (first axis slowest).
    ``population: P`` alone sweeps ``seed: [0..P-1]``: P repeats of the
    same config under member-distinct randomness.  When both are given, P
    must equal the grid size."""
    axes_in = getattr(args, "population_axes", None) or {}
    p_arg = int(getattr(args, "population", 0) or 0)
    if not axes_in and p_arg <= 1:
        return None
    bad = [k for k in axes_in if k not in HPARAM_FIELDS]
    if bad:
        raise ValueError(
            f"unknown population_axes {bad!r}; sweepable: {HPARAM_FIELDS}")
    axes = {k: tuple(v if isinstance(v, (list, tuple)) else [v])
            for k, v in axes_in.items()}
    if not axes:
        axes = {"seed": tuple(range(p_arg))}
    names = list(axes)
    grid = list(itertools.product(*[axes[n] for n in names]))
    if p_arg and p_arg != len(grid):
        raise ValueError(
            f"population={p_arg} but population_axes grid has {len(grid)} "
            "members")
    members = tuple(dict(zip(names, g)) for g in grid)
    stacked = {n: torch.tensor([m[n] for m in members],
                               dtype=torch.int32 if n == "seed"
                               else torch.float32) for n in names}
    return Population(size=len(grid), axes=axes, members=members,
                      hparams=HParams(**stacked))


def _map_tensors(fn: Callable, obj):
    """``fn`` on every tensor of a nest of dicts, tuples, lists and
    dataclasses (``ServerState``); other leaves (``None``, the host round
    counter) are kept."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def stack_member_states(state, p: int):
    """P copies of one experiment's state on a new leading member axis."""
    return _map_tensors(lambda x: torch.stack([x] * p), state)


def population_member(tree, member: int):
    """Member ``member`` of a population-stacked nest as a normal
    single-experiment one."""
    return _map_tensors(lambda x: x[member], tree)
