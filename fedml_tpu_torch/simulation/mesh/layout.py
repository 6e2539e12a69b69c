"""Mesh layout rules: who owns which bytes on the 1-D client mesh (port
of ``fedml_tpu.simulation.mesh.layout``, 1-D only).

Clients shard over the ranks in contiguous blocks; the params stay whole
on every rank; the scatter layout's flat server state (optimizer moments,
SCAFFOLD's ``c_server``, FedDyn's ``h``, Mime's momentum, the fp32 master,
the broadcast residual) keeps one contiguous chunk per rank, and the EF
rows of the quantized merge one row per rank.  The flat model pads to a
multiple of the shard count.  The 2-D ``client x model`` and 3-D pipeline
layouts of the JAX package are refused by name.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.flatmodel import FlatSpec
from ...core.mesh import Mesh, make_mesh, parse_mesh_shape
from ...ml.aggregator.agg_operator import ServerState

#: ServerState fields the scatter layout keeps as flat shard-resident
#: vectors (``opt_state``: each of its vectors)
FLAT_FIELDS = ("opt_state", "c_server", "h", "momentum", "master_flat",
               "ef_bcast")


def _refuse_unported(args) -> None:
    """The mesh shapes of the JAX package the port does not run raise
    here, naming the backend, before any process group is made."""
    backend = str(getattr(args, "backend", "mesh"))
    shape = parse_mesh_shape(getattr(args, "mesh_shape", None))
    what = None
    if shape is not None and len(shape) == 3 and shape[1] > 1:
        what = f"mesh_shape {shape}: the 3-D pipeline layout"
    elif shape is not None and shape[-1] > 1:
        what = f"mesh_shape {shape}: the 2-D client x model layout"
    for knob in ("mesh_stage", "mesh_data", "mesh_model", "mesh_seq"):
        if int(getattr(args, knob, 1) or 1) > 1:
            what = f"{knob}={getattr(args, knob)}"
    if what:
        raise NotImplementedError(
            f"backend {backend!r} (the mesh engine): {what} is not ported "
            "(the port runs the 1-D client mesh)")


class MeshLayout:
    """Static sharding policy for one 1-D mesh."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_client_shards = mesh.size
        self.rank = mesh.rank
        self.flat_multiple = mesh.size

    @classmethod
    def from_args(cls, args, mesh: Optional[Mesh] = None,
                  device=None) -> "MeshLayout":
        """The layout of ``mesh``, or of the mesh ``args`` names
        (``mesh_shape``, else the ``mesh_client`` knob) over the process
        group on ``device``."""
        _refuse_unported(args)
        if mesh is None:
            shape = parse_mesh_shape(getattr(args, "mesh_shape", None))
            client = shape[0] if shape is not None else int(
                getattr(args, "mesh_client", -1))
            mesh = make_mesh(client=client, device=device)
        return cls(mesh)

    # -- rows of the cohort and of the tables -------------------------------
    def pad_rows(self, n: int) -> int:
        """``n`` rounded up to a multiple of the shard count."""
        return -(-n // self.n_client_shards) * self.n_client_shards

    def local_rows(self, n_padded: int) -> slice:
        """This shard's contiguous block of ``n_padded`` rows."""
        per = n_padded // self.n_client_shards
        return slice(self.rank * per, (self.rank + 1) * per)

    # -- flat-model view and the server state --------------------------------
    def flat_spec_of(self, params, layout=None) -> FlatSpec:
        return FlatSpec.of(params, self.flat_multiple, layout)

    def _chunk(self, x: torch.Tensor) -> torch.Tensor:
        per = x.shape[0] // self.n_client_shards
        return x[self.rank * per:(self.rank + 1) * per].clone()

    def shard_state(self, state: ServerState, scatter: bool) -> ServerState:
        """This shard's part of a whole state (``ServerOptimizer.init`` /
        ``init_sharded``): its EF row, and in the scatter layout its chunk
        of every flat vector (scalars, like Adam's count, stay whole)."""
        changes = {}
        if state.ef_num is not None:
            changes["ef_num"] = state.ef_num[self.rank:self.rank + 1].clone()
        if scatter:
            for f in FLAT_FIELDS:
                v = getattr(state, f)
                if isinstance(v, dict):
                    changes[f] = {k: self._chunk(t) if t.dim() >= 1 else t
                                  for k, t in v.items()}
                elif v is not None:
                    changes[f] = self._chunk(v)
        return state.replace(**changes)

    def gather_state(self, state: ServerState, scatter: bool) -> ServerState:
        """Inverse of :meth:`shard_state` (a collective: every rank calls
        it): the whole state, as one controller would hold it."""
        gather = self.mesh.all_gather
        changes = {}
        if state.ef_num is not None:
            changes["ef_num"] = gather(state.ef_num)
        if scatter:
            for f in FLAT_FIELDS:
                v = getattr(state, f)
                if isinstance(v, dict):
                    changes[f] = {k: gather(t) if t.dim() >= 1 else t
                                  for k, t in v.items()}
                elif v is not None:
                    changes[f] = gather(v)
        return state.replace(**changes)
