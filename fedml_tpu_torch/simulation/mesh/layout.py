"""Mesh layout rules: who owns which bytes on the ``client × model`` mesh
(port of ``fedml_tpu.simulation.mesh.layout`` for ``n_stage_shards ==
1``).

A world of ``c·m`` ranks (``core/mesh.py``; rank = ``c_coord·m +
m_coord``):

- **1-D** (``m == 1``): clients shard over the ranks in contiguous
  blocks; the params stay whole on every rank; the scatter layout's flat
  server state (optimizer moments, SCAFFOLD's ``c_server``, FedDyn's
  ``h``, Mime's momentum, the fp32 master, the broadcast residual) keeps
  one contiguous chunk per rank, and the EF rows of the quantized merge
  one row per rank.
- **2-D** (``m > 1``): at rest a matrix leaf keeps ``1/m`` of itself on
  each rank of its model group (:meth:`MeshLayout.param_spec`: its
  largest ``m``-divisible dim, in flax's layout), vectors and scalars
  whole; the per-client table keeps its rows in blocks over the client
  groups, each row sharded as its leaf; the flat server state keeps one
  contiguous chunk per rank, chunk index = rank (the chunk order of the
  JAX package's ``P(("client", "model"))``), so each rank owns
  ``1/(c·m)`` of it; the EF rows are ``(client, model)``: the row of
  the rank's client shard, its ``m_coord``-th column chunk.  For the
  client phase a round gathers the params over the model group and runs
  its share of the cohort on every rank (the FSDP form of what GSPMD
  partitions in the JAX package): no client runs twice, no rank idles.

The flat model pads to a multiple of ``c·m``.  The 3-D pipeline layout
and the ``data`` and ``seq`` axes are refused by name.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ...core.flatmodel import FlatSpec, _canon_shape
from ...core.mesh import MODEL_AXIS, Mesh, make_mesh, parse_mesh_shape
from ...ml.aggregator.agg_operator import ServerState

#: ServerState fields the scatter layout keeps as flat shard-resident
#: vectors (``opt_state``: each of its vectors)
FLAT_FIELDS = ("opt_state", "c_server", "h", "momentum", "master_flat",
               "ef_bcast")

#: ServerState fields that are param-shaped trees in the replicated layout
TREE_FIELDS = ("c_server", "h", "momentum")

#: a leaf's dims in flax's layout → the port's (``flatmodel._to_canon``)
_CANON_TO_PORT = {"dense": (1, 0), "conv": (2, 3, 1, 0),
                  "conv_transpose": (2, 3, 0, 1)}


def mesh_shape_of(args) -> Optional[Tuple[int, int]]:
    """``(client, model)`` from ``args.mesh_shape`` or the ``mesh_*``
    knobs, or None when neither names a layout.  A 3-D shape with a stage
    factor, or a ``stage``/``data``/``seq`` knob above 1, raises by
    name."""
    backend = str(getattr(args, "backend", "mesh"))
    shape = parse_mesh_shape(getattr(args, "mesh_shape", None))
    what = None
    if shape is not None and len(shape) == 3 and shape[1] > 1:
        what = f"mesh_shape {shape}: the 3-D pipeline layout"
    for knob in ("mesh_stage", "mesh_data", "mesh_seq"):
        if int(getattr(args, knob, 1) or 1) > 1:
            what = f"{knob}={getattr(args, knob)}"
    if what:
        raise NotImplementedError(
            f"backend {backend!r} (the mesh engine): {what} is not ported "
            "(the port runs the client x model mesh)")
    if shape is not None:
        return int(shape[0]), int(shape[-1])
    model = int(getattr(args, "mesh_model", 1) or 1)
    client = int(getattr(args, "mesh_client", -1))
    return (client, model) if model > 1 or client != -1 else None


def refuse_model_factor(args, mesh: Optional[Mesh], engine: str) -> None:
    """The hierarchical and decentralized mesh engines run one client
    shard a rank: a model factor raises naming the engine."""
    shape = mesh_shape_of(args)
    m = mesh.model_size if mesh is not None else (
        shape[1] if shape is not None else 1)
    if m > 1:
        raise NotImplementedError(
            f"{engine} with a model factor of {m}: the 2-D client x model "
            "layout runs on MeshFedAvgAPI only (as in the JAX package, "
            "whose group and ring engines run one client shard a chip)")


def port_dim(canon_dim: int, kind: str) -> int:
    """The port's dim of a leaf's dim ``canon_dim`` in flax's layout."""
    perm = _CANON_TO_PORT.get(kind)
    return canon_dim if perm is None else perm[canon_dim]


class MeshLayout:
    """Static sharding policy for one mesh."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_client_shards = mesh.client_size
        self.n_model_shards = mesh.model_size
        self.two_d = self.n_model_shards > 1
        self.n_ranks = mesh.size
        self.rank = mesh.rank
        self.c_coord, self.m_coord = mesh.c_coord, mesh.m_coord
        self.flat_multiple = mesh.size
        #: the port's sharded dim of each leaf (None: whole), set by
        #: :meth:`bind`
        self.dims: Dict[str, Optional[int]] = {}

    @classmethod
    def from_args(cls, args, mesh: Optional[Mesh] = None,
                  device=None) -> "MeshLayout":
        """The layout of ``mesh``, or of the mesh ``args`` names
        (``mesh_shape``, else the ``mesh_client``/``mesh_model`` knobs)
        over the process group on ``device``."""
        shape = mesh_shape_of(args)
        if mesh is None:
            client, model = shape if shape is not None else (-1, None)
            mesh = make_mesh(client=client, model=model, device=device)
        return cls(mesh)

    # -- per-parameter partition rules ---------------------------------------
    def param_spec(self, shape) -> tuple:
        """Model-axis spec of one leaf of ``shape`` in flax's layout, as
        ``fedml_tpu``'s ``MeshLayout.param_spec``: matrices (ndim >= 2)
        shard their largest ``m``-divisible dim (the first of equals),
        vectors and scalars replicate.  ``()`` means whole."""
        shape = tuple(int(d) for d in shape)
        m = self.n_model_shards
        if m <= 1 or len(shape) < 2:
            return ()
        for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if shape[d] % m == 0 and shape[d] >= m:
                spec = [None] * len(shape)
                spec[d] = MODEL_AXIS
                return tuple(spec)
        return ()

    def bind(self, flat: FlatSpec) -> None:
        """Fix each leaf's sharded dim from the model's flat view (names,
        kinds, the port's shapes)."""
        self.dims = {}
        for name, kind, shape in zip(flat.names, flat.kinds, flat.shapes):
            spec = self.param_spec(_canon_shape(shape, kind))
            self.dims[name] = (port_dim(spec.index(MODEL_AXIS), kind)
                               if MODEL_AXIS in spec else None)

    def _dim_of(self, key: str) -> Optional[int]:
        """The sharded dim of a params-keyed leaf: ``name``, or an
        optimizer state's ``slot/name``."""
        if key in self.dims:
            return self.dims[key]
        _, _, rest = key.partition("/")
        return self.dims.get(rest)

    def _slice(self, t: torch.Tensor, d: Optional[int], off: int = 0):
        if d is None:
            return t
        n = t.shape[d + off] // self.n_model_shards
        return t.narrow(d + off, self.m_coord * n, n).contiguous()

    def _unslice(self, t: torch.Tensor, d: Optional[int], off: int = 0):
        if d is None:
            return t
        g = self.mesh.all_gather(t.movedim(d + off, 0), axis=MODEL_AXIS)
        return g.movedim(0, d + off).contiguous()

    def shard_tree(self, tree, off: int = 0):
        """This rank's model shard of a params-keyed dict (``off``:
        leading dims before the leaf's, e.g. a table's rows).  The
        identity on the 1-D layout."""
        if not self.two_d or tree is None:
            return tree
        return {k: self._slice(v, self._dim_of(k), off)
                if v.dim() > off else v for k, v in tree.items()}

    def gather_tree(self, tree, off: int = 0):
        """Inverse of :meth:`shard_tree` (a collective over the model
        group)."""
        if not self.two_d or tree is None:
            return tree
        return {k: self._unslice(v, self._dim_of(k), off)
                if v.dim() > off else v for k, v in tree.items()}

    def reduce_tree(self, tree):
        """This rank's model shard of the sum of ``tree`` over the model
        group: each sharded leaf reduce-scattered along its dim, each
        whole leaf all-reduced, all in one flat vector a kind."""
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
        """``n`` rounded up to a multiple of the rank count."""
        return -(-n // self.n_ranks) * self.n_ranks

    def local_rows(self, n_padded: int) -> slice:
        """This rank's contiguous block of ``n_padded`` cohort rows."""
        per = n_padded // self.n_ranks
        return slice(self.rank * per, (self.rank + 1) * per)

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
        """The EF rows ``(c, L)``: this rank's client row, its model
        column chunk, as ``(1, L/m)``."""
        row = x[self.c_coord:self.c_coord + 1]
        per = row.shape[1] // self.n_model_shards
        return row[:, self.m_coord * per:(self.m_coord + 1) * per].clone()

    def shard_state(self, state: ServerState, scatter: bool) -> ServerState:
        """This rank's part of a whole state (``ServerOptimizer.init`` /
        ``init_sharded``): its EF row's column chunk; in the scatter
        layout its chunk of every flat vector (scalars, like Adam's
        count, stay whole); on 2-D the params, and in the replicated
        layout every param-shaped tree, sharded over the model group."""
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
        elif self.two_d:
            for f in TREE_FIELDS + ("opt_state",):
                v = getattr(state, f)
                if v is not None:
                    changes[f] = self.shard_tree(v)
        if self.two_d:
            changes["global_params"] = self.shard_tree(state.global_params)
        return state.replace(**changes)

    def gather_state(self, state: ServerState, scatter: bool) -> ServerState:
        """Inverse of :meth:`shard_state` (a collective: every rank calls
        it): the whole state, as one controller would hold it."""
        gather = self.mesh.all_gather
        changes = {}
        if state.ef_num is not None:
            row = gather(state.ef_num[0], axis=MODEL_AXIS) if self.two_d \
                else state.ef_num[0]
            changes["ef_num"] = gather(row[None], axis="client") \
                if self.two_d else gather(state.ef_num)
        if scatter:
            for f in FLAT_FIELDS:
                v = getattr(state, f)
                if isinstance(v, dict):
                    changes[f] = {k: gather(t) if t.dim() >= 1 else t
                                  for k, t in v.items()}
                elif v is not None:
                    changes[f] = gather(v)
        elif self.two_d:
            for f in TREE_FIELDS + ("opt_state",):
                v = getattr(state, f)
                if v is not None:
                    changes[f] = self.gather_tree(v)
        if self.two_d:
            changes["global_params"] = self.gather_tree(state.global_params)
        return state.replace(**changes)
