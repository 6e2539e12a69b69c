"""The federated mesh over a ``torch.distributed`` process group (port of
``fedml_tpu.core.mesh``).

The JAX package names five mesh axes (``client``, ``stage``, ``data``,
``model``, ``seq``) over the devices of one controller.  Here one process
runs per rank and the mesh is the process group: a world of ``c·s·m·q``
ranks is laid out as the JAX package lays out its devices
(``reshape(client, stage, data, model, seq)`` with ``data`` pinned to 1),
the flat id (the rank) being ``((c_coord·s + s_coord)·m + m_coord)·q +
q_coord``.  Each axis groups the ranks that differ only in its
coordinate: ``client`` the client shards of one model slice, ``stage``
the pipeline stages of one client shard (``simulation/mesh/
pipeline.py``), ``model`` one stage's tensor-parallel slices, ``seq`` the
sequence shards of ring attention (``ops/ring_attention.py``); the pair
``(stage, model)`` groups every rank of one client shard.  Each group is
made once with ``dist.new_group``.  A ``data`` factor above 1 raises
``NotImplementedError`` naming it.

:class:`Mesh` carries the rank, the axis sizes and coordinates, the
groups and the device, and the collectives the engines use (an
all-reduce, a reduce-scatter, an all-gather and the ring shift
:meth:`Mesh.ppermute`), each over an ``axis`` (default: every rank),
written to run on both torch builds the port meets
(``reduce_scatter_single``/``all_gather_single`` where they exist, the
older ``*_tensor`` names otherwise).  On the card the group is NCCL; on
the CPU it is gloo.  A world of 1 still runs every collective (a copy),
so the card's single-rank run goes through NCCL, and a ``model`` group of
one rank runs its collectives too; a ring shift over one rank is the
identity, as JAX's ``ppermute`` over an axis of size 1.

:func:`init_world` makes the process group when none exists: from the
``torchrun`` environment when it names a world above 1, else a world of 1
over an in-process store; :func:`shutdown_world` tears it down.
"""

from __future__ import annotations

import gc
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

CLIENT_AXIS = "client"
STAGE_AXIS = "stage"
DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"

ALL_AXES = (CLIENT_AXIS, STAGE_AXIS, DATA_AXIS, MODEL_AXIS, SEQ_AXIS)

#: the axes a rank's coordinates run over, outermost first (``data`` is
#: pinned to 1: intra-silo data parallelism is not ported)
GRID_AXES = (CLIENT_AXIS, STAGE_AXIS, MODEL_AXIS, SEQ_AXIS)

#: the pair of axes that spans one client shard's ranks
SHARD_AXES = (STAGE_AXIS, MODEL_AXIS)

#: the groups of a layout, made once per process group (``dist.new_group``
#: is collective: every rank makes every group, in one order)
_GROUPS = {}


def _backend_for(device: torch.device) -> str:
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError(
                "the mesh on the card needs NCCL, and this torch build has "
                "none; pass device='cpu' to run the mesh over gloo")
        return "nccl"
    return "gloo"


def init_world(device) -> None:
    """Make the default process group if there is none: ``env://`` when
    ``WORLD_SIZE`` names more than one rank (``torchrun``), else a world of
    1 over an in-process store.  NCCL on the card, gloo on the CPU.  An
    existing group whose backend does not serve ``device`` raises: the
    mesh never moves to another device or backend unasked."""
    device = torch.device(device)
    backend = _backend_for(device)
    if dist.is_initialized():
        have = str(dist.get_backend()).lower()
        if backend not in have:
            raise RuntimeError(
                f"the process group runs {have!r}, and the mesh on "
                f"{device.type} needs {backend!r}")
        return
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def shutdown_world() -> None:
    """Tear the default process group down, if there is one: collect
    garbage, wait for the card, meet every rank at a barrier, then
    ``destroy_process_group``.  Call it on every rank.

    A CUDA graph that captured NCCL collectives (``round_block`` on the
    mesh) holds a reference on the communicator, and NCCL's destroy waits
    until every such graph is gone: with a live graph the call never
    returns.  ``MeshFedAvgAPI.train`` releases its graphs when it ends;
    a caller that keeps a block function of its own releases it
    (``BlockRoundFn.release``) before calling this."""
    if not dist.is_initialized():
        return
    _GROUPS.clear()
    gc.collect()
    if "nccl" in str(dist.get_backend()).lower():
        torch.cuda.synchronize()
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
    dist.destroy_process_group()


def _coords(rank: int, dims: dict) -> dict:
    """A rank's coordinate on each of :data:`GRID_AXES` (row-major, the
    last axis fastest)."""
    out = {}
    for axis in reversed(GRID_AXES):
        out[axis] = rank % dims[axis]
        rank //= dims[axis]
    return out


def _rank_of(coords: dict, dims: dict) -> int:
    r = 0
    for axis in GRID_AXES:
        r = r * dims[axis] + coords[axis]
    return r


def _members(coords: dict, dims: dict, axes) -> list:
    """The ranks that share every coordinate of ``coords`` off ``axes``,
    ordered by their coordinates along ``axes`` (row-major)."""
    out = [dict(coords)]
    for axis in axes:
        out = [dict(c, **{axis: i}) for c in out for i in range(dims[axis])]
    return [_rank_of(c, dims) for c in out]


def _axis_groups(dims: dict, kinds) -> dict:
    """``{kind: {members: group}}`` for each kind of group (a tuple of
    axes): every group of the kind, made on every rank in one order.  A
    group of the whole world is the default group (``None``), but a model
    group is always a group of its own: the tensor-parallel code runs its
    collectives there, on one rank too."""
    world = math.prod(dims.values())
    key = (id(dist.distributed_c10d._get_default_group()),
           tuple(dims[a] for a in GRID_AXES), tuple(kinds))
    if key not in _GROUPS:
        made = {}
        for kind in kinds:
            seen = {}
            for r in range(world):
                ranks = tuple(_members(_coords(r, dims), dims, kind))
                if ranks in seen:
                    continue
                seen[ranks] = None if kind != (MODEL_AXIS,) and \
                    len(ranks) == world else dist.new_group(list(ranks))
            made[kind] = seen
        _GROUPS[key] = made
    return _GROUPS[key]


class Mesh:
    """The federated mesh over the process group: ``size`` ranks (the
    world), this process being rank ``rank``, its tensors on ``device``.
    ``model``, ``stage`` and ``seq`` are the axis factors (the client
    factor takes the ranks they leave); ``groups`` maps an axis name (or
    a tuple of axes) to this rank's process group along it (``None``: the
    default group).  Without groups (the default) the mesh is the 1-D
    client mesh over ``group``."""

    def __init__(self, size: int, rank: int, device, group=None,
                 model: int = 1, groups: Optional[dict] = None,
                 stage: int = 1, seq: int = 1):
        self.size = int(size)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.group = group
        self.model_size = int(model)
        self.stage_size = int(stage)
        self.seq_size = int(seq)
        self.client_size = self.size // (self.model_size * self.stage_size
                                          * self.seq_size)
        self.dims = {CLIENT_AXIS: self.client_size,
                     STAGE_AXIS: self.stage_size,
                     MODEL_AXIS: self.model_size, SEQ_AXIS: self.seq_size}
        self.coords = _coords(self.rank, self.dims)
        #: this rank's coordinates: rank = ((c·s + s)·m + m)·q + q
        self.c_coord = self.coords[CLIENT_AXIS]
        self.s_coord = self.coords[STAGE_AXIS]
        self.m_coord = self.coords[MODEL_AXIS]
        self.q_coord = self.coords[SEQ_AXIS]
        self.groups = dict(groups or {CLIENT_AXIS: group})
        #: axis sizes, as ``jax.sharding.Mesh.shape`` reads
        self.shape = {a: 1 for a in ALL_AXES}
        self.shape.update(self.dims)

    def __repr__(self):
        return (f"Mesh(client={self.client_size}, stage={self.stage_size}, "
                f"model={self.model_size}, seq={self.seq_size}, "
                f"rank={self.rank}, device={self.device})")

    @staticmethod
    def _axes(axis):
        """``axis`` as a tuple of axis names (None: every axis)."""
        if axis is None:
            return GRID_AXES
        return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)

    def _group(self, axis):
        """The process group of ``axis`` (a name or a tuple of names):
        this rank's group along it, None for the default group (every
        rank)."""
        if axis is None:
            return self.group
        axes = self._axes(axis)
        for a in axes:
            if a not in self.dims:
                raise ValueError(f"mesh axis {a!r}: the port's mesh has "
                                 f"{', '.join(map(repr, GRID_AXES))}")
        key = axes[0] if len(axes) == 1 else axes
        if key in self.groups:
            return self.groups[key]
        if self.axis_size(axes) == self.size:
            return self.group
        names = axis if isinstance(axis, str) else tuple(axis)
        raise ValueError(
            f"this mesh has no {names!r} group (make it with "
            "make_mesh(model=..., stage=..., seq=...) or make_mesh2d)")

    def axis_size(self, axis=None) -> int:
        return math.prod(self.dims[a] for a in self._axes(axis))

    def coord(self, axis) -> int:
        """This rank's coordinate along ``axis`` (row-major over a
        tuple)."""
        c = 0
        for a in self._axes(axis):
            c = c * self.dims[a] + self.coords[a]
        return c

    def _peer(self, axis, coord: int) -> int:
        """The global rank at coordinate ``coord`` of this rank's group
        along ``axis``."""
        return _members(self.coords, self.dims, self._axes(axis))[coord]

    # -- collectives ---------------------------------------------------------
    def psum(self, t: torch.Tensor, axis=None) -> torch.Tensor:
        """Sum of ``t`` over ``axis`` (default: every rank; a new
        tensor)."""
        out = t.clone()
        dist.all_reduce(out, group=self._group(axis))
        return out

    def psum_many(self, tensors, axis=None):
        """Each of ``tensors`` summed over ``axis``, in one all-reduce of
        their concatenation (one dtype); a list of the same shapes."""
        flat = self.psum(torch.cat([t.reshape(-1) for t in tensors]), axis)
        out, off = [], 0
        for t in tensors:
            out.append(flat[off:off + t.numel()].reshape(t.shape))
            off += t.numel()
        return out

    def psum_scatter(self, vec: torch.Tensor, axis=None) -> torch.Tensor:
        """This rank's contiguous chunk (in its coordinate along ``axis``)
        of the sum of ``vec`` over ``axis`` (``vec``'s length divides by
        the axis size)."""
        n = self.axis_size(axis)
        out = torch.empty(vec.shape[0] // n, dtype=vec.dtype,
                          device=vec.device)
        fn = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        fn(out, vec.contiguous(), group=self._group(axis))
        return out

    def all_gather(self, chunk: torch.Tensor, axis=None) -> torch.Tensor:
        """The chunks of the ranks along ``axis`` concatenated along dim
        0, in coordinate order."""
        n = self.axis_size(axis)
        out = torch.empty((n * chunk.shape[0],) + tuple(chunk.shape[1:]),
                          dtype=chunk.dtype, device=chunk.device)
        fn = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        fn(out, chunk.contiguous(), group=self._group(axis))
        return out

    def ppermute(self, t: torch.Tensor, axis, shift: int = 1
                 ) -> torch.Tensor:
        """The ring shift along ``axis`` (JAX's ``ppermute`` with the perm
        ``i -> (i + shift) % n``): this rank sends ``t`` to the rank
        ``shift`` places on and returns what the rank ``shift`` places
        back sent, by one ``batch_isend_irecv``.  The identity over one
        rank."""
        n = self.axis_size(axis)
        if n == 1 or shift % n == 0:
            return t.clone()
        me = self.coord(axis)
        t = t.contiguous()
        out = torch.empty_like(t)
        group = self._group(axis)
        ops = [dist.P2POp(dist.isend, t, self._peer(axis, (me + shift) % n),
                          group),
               dist.P2POp(dist.irecv, out,
                          self._peer(axis, (me - shift) % n), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


def make_mesh(client: int = -1, stage: int = 1, data: int = 1,
              model: Optional[int] = None, seq: int = 1,
              device=None) -> Mesh:
    """The canonical federated mesh over the process group (made by
    :func:`init_world` when there is none): ``client × stage × model ×
    seq`` ranks in the JAX package's order.  ``client=-1`` absorbs the
    ranks the other factors leave; any other value must fill the world
    with them.  ``device`` defaults to the card (``cuda:LOCAL_RANK``).  A
    ``model`` factor given (1 too), or a ``stage`` or ``seq`` factor above
    1, makes every axis's groups, so the tensor-parallel code runs over a
    model group, of one rank at ``model=1``; without them the mesh is the
    1-D client mesh over the world, with no groups.  A ``data`` factor
    above 1 raises by name (intra-silo data parallelism is not ported)."""
    if int(data) > 1:
        raise NotImplementedError(
            f"mesh axis {DATA_AXIS!r} of size {data}: intra-silo data "
            "parallelism is not ported (the port runs the client x stage x "
            "model x seq mesh)")
    stage, seq = int(stage), int(seq)
    if stage < 1 or seq < 1:
        raise ValueError(f"stage and seq factors must be >= 1, got "
                         f"{stage} and {seq}")
    grid = model is not None or stage > 1 or seq > 1
    model = 1 if model is None else int(model)
    if model < 1:
        raise ValueError(f"model factor must be >= 1, got {model}")
    if device is None:
        from ..device import card_device
        device = card_device()
    init_world(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    fixed = model * stage * seq
    if world % fixed:
        raise ValueError(
            f"stage x model x seq = {stage} x {model} x {seq} does not "
            f"divide the {world} ranks of the process group")
    if int(client) not in (-1, world // fixed):
        factors = [client] + [f for f in (stage, model, seq) if f > 1] \
            if stage > 1 or seq > 1 else [client, model]
        raise ValueError(
            f"mesh wants {' x '.join(map(str, factors))} ranks, and the "
            f"process group has {world} (start them with torchrun or "
            "simulation.mesh.launch.spawn)")
    if not grid:
        return Mesh(world, rank, device)
    dims = {CLIENT_AXIS: world // fixed, STAGE_AXIS: stage,
            MODEL_AXIS: model, SEQ_AXIS: seq}
    kinds = [(a,) for a in GRID_AXES] + [SHARD_AXES]
    made = _axis_groups(dims, kinds)
    coords = _coords(rank, dims)
    groups = {kind[0] if len(kind) == 1 else kind:
              made[kind][tuple(_members(coords, dims, kind))]
              for kind in kinds}
    return Mesh(world, rank, device, model=model, groups=groups,
                stage=stage, seq=seq)


def make_mesh2d(mesh_shape, device=None) -> Mesh:
    """The 2-D ``(client, model)`` or 3-D ``(client, stage, model)`` mesh
    of ``mesh_shape`` (``"c,m"``, ``"cxm"``, ``"c,s,m"`` or a pair or
    triple; ``-1`` in the client slot takes the ranks the other factors
    leave)."""
    shape = parse_mesh_shape(mesh_shape)
    if shape is None:
        raise ValueError("make_mesh2d needs a mesh shape, got None")
    if len(shape) == 3:
        return make_mesh(client=shape[0], stage=shape[1], model=shape[2],
                         device=device)
    return make_mesh(client=shape[0], model=shape[1], device=device)


def parse_mesh_shape(value) -> Optional[tuple]:
    """Normalize ``args.mesh_shape`` to ``(n_client_shards,
    n_model_shards)`` or ``(n_client_shards, n_stage_shards,
    n_model_shards)`` or None.  Accepts a 2-/3-tuple/list, or a string
    like ``"4,2"`` / ``"4x2"`` / ``"2,2,2"``; ``-1`` in the client slot
    absorbs the remaining devices (``make_mesh`` semantics)."""
    if value in (None, "", "none", "auto"):
        return None
    if isinstance(value, str):
        parts = value.replace("x", ",").split(",")
        value = [int(p) for p in parts if p.strip()]
    shape = tuple(int(v) for v in value)
    if len(shape) not in (2, 3):
        raise ValueError(
            f"mesh_shape must be (n_client_shards, n_model_shards) or "
            f"(n_client_shards, n_stage_shards, n_model_shards), "
            f"got {shape!r}")
    if len(shape) == 3 and shape[1] < 1:
        raise ValueError(f"n_stage_shards must be >= 1, got {shape[1]}")
    if shape[-1] < 1:
        raise ValueError(f"n_model_shards must be >= 1, got {shape[-1]}")
    return shape


def single_device_mesh(device=None) -> Mesh:
    return make_mesh(client=1, device=device)


def pad_to_multiple(n: int, k: int) -> int:
    return int(math.ceil(n / k) * k)
