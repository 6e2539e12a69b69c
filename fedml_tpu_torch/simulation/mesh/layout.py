"""Mesh layout rules: who owns which bytes on the ``client × model`` and
``client × stage × model`` meshes (port of
``fedml_tpu.simulation.mesh.layout``).

A world of ``c·s·m`` ranks (``core/mesh.py``; rank = ``(c_coord·s +
s_coord)·m + m_coord``):

- **1-D** (``s == m == 1``): clients shard over the ranks in contiguous
  blocks; the params stay whole on every rank; the scatter layout's flat
  server state (optimizer moments, SCAFFOLD's ``c_server``, FedDyn's
  ``h``, Mime's momentum, the fp32 master, the broadcast residual) keeps
  one contiguous chunk per rank, and the EF rows of the quantized merge
  one row per rank.
- **2-D** (``m > 1``, ``mesh_shape="c,m"``): at rest a matrix leaf keeps
  ``1/m`` of itself on each rank of its model group
  (:meth:`MeshLayout.param_spec`: its largest ``m``-divisible dim, in
  flax's layout), vectors and scalars whole; the per-client table keeps
  its rows in blocks over the client groups, each row sharded as its
  leaf; the flat server state keeps one contiguous chunk per rank, chunk
  index = rank (the chunk order of the JAX package's ``P(("client",
  "model"))``), so each rank owns ``1/(c·m)`` of it; the EF rows are
  ``(client, model)``: the row of the rank's client shard, its
  ``m_coord``-th column chunk.  For the client phase a round gathers the
  params over the model group and runs its share of the cohort on every
  rank (the FSDP form of what GSPMD partitions in the JAX package): no
  client runs twice, no rank idles.
- **3-D** (``mesh_shape="c,s,m"``, the pipeline layout): the model's
  staged leaves (``TorchModel.pipeline.stage_leaves``, stacked on a layer
  axis) split dim 0 over ``stage`` in contiguous chunks and, for ndim >=
  3, dim 1 over ``model`` (row-parallel); every other leaf is whole on
  every rank.  The cohort shards over the client groups only: the
  ``s·m`` ranks of a client shard train its clients together, as one
  microbatched pipeline (``pipeline.py``), on their shards.  The flat
  server state chunks over all ``c·s·m`` ranks (chunk = rank, the JAX
  package's ``P(("client", "stage", "model"))``), and the EF rows keep
  their rows on ``client`` and their columns on ``(stage, model)``.  A
  3-tuple shape selects this layout at ``s == 1`` too when the model is
  staged (the JAX package's only above 1; the round computes the same
  function either way); an unstaged model there runs the 2-D layout of
  ``(c, m)``, as in the JAX package.

The flat model pads to a multiple of ``c·s·m``.  A ``data`` factor, and
a ``seq`` factor on the simulation engine (it has no sequence axis: ring
attention runs in the causal LM, ``llm/model.py``), are refused by name.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ...core.flatmodel import FlatSpec, _canon_shape
from ...core.mesh import (CLIENT_AXIS, MODEL_AXIS, SHARD_AXES, STAGE_AXIS,
                          Mesh, make_mesh, parse_mesh_shape)
from ...ml.aggregator.agg_operator import ServerState

#: ServerState fields the scatter layout keeps as flat shard-resident
#: vectors (``opt_state``: each of its vectors)
FLAT_FIELDS = ("opt_state", "c_server", "h", "momentum", "master_flat",
               "ef_bcast")

#: the refusal of a model without a ``PipelineDef`` on the pipeline layout
NO_STAGED_MODEL = ("the 3-D pipeline layout (mesh_shape 'c,s,m') needs a "
                   "staged model: use model='pipe_mlp' or any model carrying "
                   "a PipelineDef")

#: ServerState fields that are param-shaped trees in the replicated layout
TREE_FIELDS = ("c_server", "h", "momentum")

#: a leaf's dims in flax's layout → the port's (``flatmodel._to_canon``)
_CANON_TO_PORT = {"dense": (1, 0), "conv": (2, 3, 1, 0),
                  "conv_transpose": (2, 3, 0, 1)}


def mesh_shape_of(args) -> Optional[tuple]:
    """``(client, model)`` or ``(client, stage, model)`` from
    ``args.mesh_shape`` (which wins when set) or the ``mesh_*`` knobs (a
    triple when ``mesh_stage`` exceeds 1), or None when neither names a
    layout.  A ``data`` or ``seq`` factor above 1 raises by name."""
    backend = str(getattr(args, "backend", "mesh"))
    for knob, what in (("mesh_data", "intra-silo data parallelism"),
                       ("mesh_seq", "a sequence axis (the simulation engine "
                        "has none: ring attention runs in the causal LM, "
                        "LlamaLM(cfg, mesh=make_mesh(seq=...)))")):
        if int(getattr(args, knob, 1) or 1) > 1:
            raise NotImplementedError(
                f"backend {backend!r} (the mesh engine): "
                f"{knob}={getattr(args, knob)}: {what} is not ported")
    shape = parse_mesh_shape(getattr(args, "mesh_shape", None))
    if shape is not None:
        return tuple(int(v) for v in shape)
    model = int(getattr(args, "mesh_model", 1) or 1)
    stage = int(getattr(args, "mesh_stage", 1) or 1)
    client = int(getattr(args, "mesh_client", -1))
    if stage > 1:
        return client, stage, model
    return (client, model) if model > 1 or client != -1 else None


def refuse_model_factor(args, mesh: Optional[Mesh], engine: str) -> None:
    """The hierarchical and decentralized mesh engines run one client
    shard a rank: a model or stage factor raises naming the engine."""
    shape = mesh_shape_of(args)
    if mesh is not None:
        m = mesh.model_size * getattr(mesh, "stage_size", 1)
    else:
        m = 1 if shape is None else shape[-1] * (
            shape[1] if len(shape) == 3 else 1)
    if m > 1:
        raise NotImplementedError(
            f"{engine} with a model or stage factor of {m}: the 2-D and "
            "3-D layouts run on MeshFedAvgAPI only (as in the JAX package, "
            "whose group and ring engines run one client shard a chip)")


def port_dim(canon_dim: int, kind: str) -> int:
    """The port's dim of a leaf's dim ``canon_dim`` in flax's layout."""
    perm = _CANON_TO_PORT.get(kind)
    return canon_dim if perm is None else perm[canon_dim]


class MeshLayout:
    """Static sharding policy for one mesh.  ``stage_leaves`` names the
    staged parameters (required on the pipeline layout); ``three_d``
    selects the pipeline layout at a stage factor of 1 (a 3-tuple
    ``mesh_shape``)."""

    def __init__(self, mesh: Mesh, stage_leaves=(), three_d: bool = False):
        self.mesh = mesh
        self.n_client_shards = mesh.client_size
        self.n_stage_shards = int(getattr(mesh, "stage_size", 1))
        self.n_model_shards = mesh.model_size
        self.stage_leaves = tuple(stage_leaves)
        #: the 3-D pipeline layout (module docstring)
        self.pipeline = self.n_stage_shards > 1 or bool(three_d)
        if self.pipeline and not self.stage_leaves:
            raise ValueError(NO_STAGED_MODEL)
        #: the 2-D FSDP form (params gathered for the client phase)
        self.two_d = self.n_model_shards > 1 and not self.pipeline
        #: whether params rest sharded (2-D or 3-D)
        self.sharded = self.two_d or self.pipeline
        self.n_ranks = mesh.size
        self.rank = mesh.rank
        self.c_coord, self.m_coord = mesh.c_coord, mesh.m_coord
        self.s_coord = int(getattr(mesh, "s_coord", 0))
        #: the ranks of one client shard and this rank's place among them
        self.n_shard_ranks = self.n_stage_shards * self.n_model_shards
        self.shard_coord = self.s_coord * self.n_model_shards + self.m_coord
        self.shard_axis = SHARD_AXES if self.pipeline else MODEL_AXIS
        #: the cohort's clients spread over every rank (1-D, 2-D) or over
        #: the client shards (3-D); ``cohort_axis`` reduces over them
        self.row_shards = self.n_client_shards if self.pipeline \
            else self.n_ranks
        self.row_coord = self.c_coord if self.pipeline else self.rank
        self.cohort_axis = CLIENT_AXIS if self.pipeline else None
        self.flat_multiple = mesh.size
        #: ``{leaf name: ((port dim, axis), ...)}``: how each leaf splits
        #: at rest, set by :meth:`bind`
        self.splits: Dict[str, tuple] = {}

    @classmethod
    def from_args(cls, args, mesh: Optional[Mesh] = None,
                  device=None, model=None) -> "MeshLayout":
        """The layout of ``mesh``, or of the mesh ``args`` names
        (``mesh_shape``, else the ``mesh_*`` knobs) over the process group
        on ``device``.  ``model`` (a ``TorchModel``) names the staged
        leaves."""
        shape = mesh_shape_of(args)
        three_d = shape is not None and len(shape) == 3
        pipe = getattr(model, "pipeline", None)
        stages = shape[1] if three_d else getattr(mesh, "stage_size", 1)
        if stages > 1 and pipe is None:
            # refused before any process group is made
            raise ValueError(NO_STAGED_MODEL)
        if mesh is None:
            if shape is None:
                mesh = make_mesh(device=device)
            elif three_d:
                mesh = make_mesh(client=shape[0], stage=shape[1],
                                 model=shape[2], device=device)
            else:
                mesh = make_mesh(client=shape[0], model=shape[1],
                                 device=device)
        return cls(mesh, getattr(pipe, "stage_leaves", ()),
                   three_d and pipe is not None)

    # -- per-parameter partition rules ---------------------------------------
    def param_spec(self, shape, staged: bool = False) -> tuple:
        """Spec of one leaf of ``shape`` in flax's layout, as
        ``fedml_tpu``'s ``MeshLayout.param_spec``.  Pipeline layout: a
        staged leaf splits dim 0 over ``stage`` and, for ndim >= 3 with a
        model factor, dim 1 over ``model``; other leaves are whole.  2-D:
        matrices (ndim >= 2) shard their largest ``m``-divisible dim (the
        first of equals), vectors and scalars replicate.  ``()`` means
        whole."""
        shape = tuple(int(d) for d in shape)
        m = self.n_model_shards
        if self.pipeline:
            if not staged:
                return ()
            spec = [None] * len(shape)
            spec[0] = STAGE_AXIS
            if m > 1 and len(shape) >= 3 and shape[1] % m == 0 \
                    and shape[1] >= m:
                spec[1] = MODEL_AXIS
            return tuple(spec)
        if m <= 1 or len(shape) < 2:
            return ()
        for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if shape[d] % m == 0 and shape[d] >= m:
                spec = [None] * len(shape)
                spec[d] = MODEL_AXIS
                return tuple(spec)
        return ()

    def bind(self, flat: FlatSpec) -> None:
        """Fix each leaf's split from the model's flat view (names, kinds,
        the port's shapes).  An axis of one rank splits nothing."""
        self.splits = {}
        for name, kind, shape in zip(flat.names, flat.kinds, flat.shapes):
            spec = self.param_spec(_canon_shape(shape, kind),
                                   name in self.stage_leaves)
            size = {STAGE_AXIS: self.n_stage_shards,
                    MODEL_AXIS: self.n_model_shards}
            self.splits[name] = tuple(
                (port_dim(d, kind), axis) for d, axis in enumerate(spec)
                if axis is not None and size[axis] > 1)
            if self.pipeline and name in self.stage_leaves and \
                    shape[0] % self.n_stage_shards:
                raise ValueError(
                    f"staged leaf {name!r} depth {shape[0]} must divide by "
                    f"n_stage_shards={self.n_stage_shards} (contiguous "
                    "layer chunks per stage)")

    @property
    def dims(self) -> Dict[str, Optional[int]]:
        """``{leaf name: its first split dim}`` (None: whole)."""
        return {k: sp[0][0] if sp else None for k, sp in self.splits.items()}

    def _splits(self, key: str) -> tuple:
        """The splits of a params-keyed leaf: ``name``, or an optimizer
        state's ``slot/name``."""
        if key in self.splits:
            return self.splits[key]
        _, _, rest = key.partition("/")
        return self.splits.get(rest, ())

    def _dim_of(self, key: str) -> Optional[int]:
        """The model-sharded dim of a leaf on 2-D (None: whole)."""
        sp = self._splits(key)
        return sp[0][0] if sp else None

    def _slice(self, t: torch.Tensor, splits, off: int = 0):
        for d, axis in splits:
            n = t.shape[d + off] // self.mesh.axis_size(axis)
            t = t.narrow(d + off, self.mesh.coord(axis) * n, n)
        return t.contiguous() if splits else t

    def _unslice(self, t: torch.Tensor, splits, off: int = 0):
        for d, axis in reversed(splits):
            g = self.mesh.all_gather(t.movedim(d + off, 0), axis=axis)
            t = g.movedim(0, d + off)
        return t.contiguous() if splits else t

    def shard_tree(self, tree, off: int = 0):
        """This rank's shard of a params-keyed dict (``off``: leading dims
        before the leaf's, e.g. a table's rows).  The identity on the 1-D
        layout."""
        if not self.sharded or tree is None:
            return tree
        return {k: self._slice(v, self._splits(k), off)
                if v.dim() > off else v for k, v in tree.items()}

    def gather_tree(self, tree, off: int = 0):
        """Inverse of :meth:`shard_tree` (a collective over the model
        group, and on 3-D the stage group)."""
        if not self.sharded or tree is None:
            return tree
        return {k: self._unslice(v, self._splits(k), off)
                if v.dim() > off else v for k, v in tree.items()}

    def place(self, tree):
        """On 3-D: each leaf of a params-keyed dict of this rank's shards
        as its whole shape, zero outside this rank's shard, and zero
        everywhere on the ranks that repeat it (a leaf not split over
        ``stage`` or ``model`` counts on coordinate 0 of that axis only).
        Summed over the ranks of a client shard that is the whole tree;
        the identity on 1-D and 2-D."""
        if not self.pipeline:
            return tree
        out = {}
        for k, v in tree.items():
            splits = self._splits(k)
            split_axes = {axis for _, axis in splits}
            if any(self.mesh.coord(a) for a in SHARD_AXES
                   if a not in split_axes):
                out[k] = torch.zeros(
                    self._whole_shape(v.shape, splits), dtype=v.dtype,
                    device=v.device)
                continue
            if not splits:
                out[k] = v
                continue
            idx = [slice(None)] * v.dim()
            for d, axis in splits:
                c = self.mesh.coord(axis)
                idx[d] = slice(c * v.shape[d], (c + 1) * v.shape[d])
            whole = v.new_zeros(self._whole_shape(v.shape, splits))
            whole[tuple(idx)] = v
            out[k] = whole
        return out

    def leaf_weight(self, key: str) -> float:
        """1.0 when this rank's shard of leaf ``key`` counts in a sum over
        the ranks of a client shard, 0.0 on the ranks that repeat it (the
        rule of :meth:`place`: a leaf not split over an axis counts on
        coordinate 0 of that axis only).  Always 1.0 on 1-D."""
        if not self.sharded:
            return 1.0
        split_axes = {axis for _, axis in self._splits(key)}
        axes = SHARD_AXES if self.pipeline else (MODEL_AXIS,)
        return 0.0 if any(self.mesh.coord(a) for a in axes
                          if a not in split_axes) else 1.0

    def _whole_shape(self, shape, splits) -> list:
        shape = list(shape)
        for d, axis in splits:
            shape[d] *= self.mesh.axis_size(axis)
        return shape

    def reduce_tree(self, tree):
        """This rank's model shard of the sum of ``tree`` over the model
        group (2-D): each sharded leaf reduce-scattered along its dim,
        each whole leaf all-reduced, all in one flat vector a kind."""
        if not self.two_d:
            return tree
        mesh = self.mesh
        out = {}
        split = {k: v for k, v in tree.items() if self._dim_of(k) is not None}
        whole = {k: v for k, v in tree.items() if k not in split}
        if split:
            m = self.n_model_shards
            # each leaf as (m, rest): the reduce-scatter's chunk j is
            # every leaf's j-th slice
            parts = [v.movedim(self._dim_of(k), 0).reshape(m, -1)
                     for k, v in split.items()]
            vec = torch.cat(parts, dim=1).reshape(-1)
            got = mesh.psum_scatter(vec, axis=MODEL_AXIS)
            off = 0
            for (k, v), p in zip(split.items(), parts):
                d = self._dim_of(k)
                n = p.shape[1]
                shape = list(v.movedim(d, 0).shape)
                shape[0] //= m
                out[k] = got[off:off + n].reshape(shape).movedim(0, d)
                off += n
        if whole:
            out.update(zip(whole, mesh.psum_many(list(whole.values()),
                                                 axis=MODEL_AXIS)))
        return {k: out[k] for k in tree}

    # -- rows of the cohort and of the tables --------------------------------
    def pad_rows(self, n: int) -> int:
        """``n`` rounded up to a multiple of the row shards (the ranks;
        the client shards on 3-D)."""
        return -(-n // self.row_shards) * self.row_shards

    def local_rows(self, n_padded: int) -> slice:
        """This rank's contiguous block of ``n_padded`` cohort rows."""
        per = n_padded // self.row_shards
        return slice(self.row_coord * per, (self.row_coord + 1) * per)

    def pad_table_rows(self, n: int) -> int:
        """``n`` table rows rounded up to a multiple of the client
        shards."""
        return -(-n // self.n_client_shards) * self.n_client_shards

    # -- flat-model view and the server state --------------------------------
    def flat_spec_of(self, params, layout=None) -> FlatSpec:
        return FlatSpec.of(params, self.flat_multiple, layout)

    def _chunk(self, x: torch.Tensor) -> torch.Tensor:
        per = x.shape[0] // self.n_ranks
        return x[self.rank * per:(self.rank + 1) * per].clone()

    def _ef_cols(self, x: torch.Tensor) -> torch.Tensor:
        """The EF rows ``(c, L)``: this rank's client row, its column
        chunk over the client shard's ranks, as ``(1, L/(s·m))``."""
        row = x[self.c_coord:self.c_coord + 1]
        per = row.shape[1] // self.n_shard_ranks
        lo = self.shard_coord * per
        return row[:, lo:lo + per].clone()

    def shard_state(self, state: ServerState, scatter: bool) -> ServerState:
        """This rank's part of a whole state (``ServerOptimizer.init`` /
        ``init_sharded``): its EF row's column chunk; in the scatter
        layout its chunk of every flat vector (scalars, like Adam's
        count, stay whole); on 2-D and 3-D the params, and in the
        replicated layout every param-shaped tree, sharded."""
        changes = {}
        if state.ef_num is not None:
            changes["ef_num"] = self._ef_cols(state.ef_num)
        if scatter:
            for f in FLAT_FIELDS:
                v = getattr(state, f)
                if isinstance(v, dict):
                    changes[f] = {k: self._chunk(t) if t.dim() >= 1 else t
                                  for k, t in v.items()}
                elif v is not None:
                    changes[f] = self._chunk(v)
        elif self.sharded:
            for f in TREE_FIELDS + ("opt_state",):
                v = getattr(state, f)
                if v is not None:
                    changes[f] = self.shard_tree(v)
        if self.sharded:
            changes["global_params"] = self.shard_tree(state.global_params)
        return state.replace(**changes)

    def gather_state(self, state: ServerState, scatter: bool) -> ServerState:
        """Inverse of :meth:`shard_state` (a collective: every rank calls
        it): the whole state, as one controller would hold it."""
        gather = self.mesh.all_gather
        changes = {}
        if state.ef_num is not None:
            if self.sharded:
                row = gather(state.ef_num[0], axis=self.shard_axis)
                changes["ef_num"] = gather(row[None], axis=CLIENT_AXIS)
            else:
                changes["ef_num"] = gather(state.ef_num)
        if scatter:
            for f in FLAT_FIELDS:
                v = getattr(state, f)
                if isinstance(v, dict):
                    changes[f] = {k: gather(t) if t.dim() >= 1 else t
                                  for k, t in v.items()}
                elif v is not None:
                    changes[f] = gather(v)
        elif self.sharded:
            for f in TREE_FIELDS + ("opt_state",):
                v = getattr(state, f)
                if v is not None:
                    changes[f] = self.gather_tree(v)
        if self.sharded:
            changes["global_params"] = self.gather_tree(state.global_params)
        return state.replace(**changes)
