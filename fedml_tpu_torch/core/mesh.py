"""The federated mesh over a ``torch.distributed`` process group (port of
``fedml_tpu.core.mesh``).

The JAX package names five mesh axes (``client``, ``stage``, ``data``,
``model``, ``seq``) over the devices of one controller.  Here one process
runs per rank and the mesh is the process group: a world of ``c·m`` ranks
is laid out as the JAX package lays out its devices, the flat id (the
rank) being ``c_coord·m + m_coord`` with ``stage``, ``data`` and ``seq``
pinned to 1.  The ``client`` axis groups the ranks with the same
``m_coord``, the ``model`` axis the ranks with the same ``c_coord`` (one
client's model, tensor-parallel); each group is made once with
``dist.new_group``.  A factor above 1 on ``stage``, ``data`` or ``seq``
raises ``NotImplementedError`` naming it.

:class:`Mesh` carries the rank, the world size, the groups and the device,
and the three collectives the engines use (an all-reduce, a reduce-scatter
and an all-gather), each over an ``axis`` (default: every rank), written
to run on both torch builds the port meets (``reduce_scatter_single``/
``all_gather_single`` where they exist, the older ``*_tensor`` names
otherwise).  On the card the group is NCCL; on the CPU it is gloo.  A
world of 1 still runs every collective (a copy), so the card's
single-rank run goes through NCCL, and a ``model`` group of one rank runs
its collectives too.

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

#: what each unported axis belongs to, for the refusal's message
_UNPORTED_AXES = {
    STAGE_AXIS: "the 3-D pipeline layout",
    DATA_AXIS: "intra-silo data parallelism",
    SEQ_AXIS: "sequence parallelism (ring attention)",
}

#: the client and model groups of a (world, c, m) layout, made once per
#: process group (``dist.new_group`` is collective: every rank makes every
#: group, in one order)
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


def _axis_groups(world: int, c: int, m: int):
    """``(client_groups, model_groups)`` of the layout: the client group of
    ``m_coord`` j holds the ranks ``c·m + j``, the model group of
    ``c_coord`` i the ranks ``i·m .. i·m + m - 1``.  With ``m == 1`` the
    client axis is the whole world (the default group, ``None``)."""
    key = (id(dist.distributed_c10d._get_default_group()), world, c, m)
    if key not in _GROUPS:
        model = [dist.new_group([i * m + j for j in range(m)])
                 for i in range(c)]
        client = [None] if m == 1 else [
            dist.new_group([i * m + j for i in range(c)]) for j in range(m)]
        _GROUPS[key] = (client, model)
    return _GROUPS[key]


class Mesh:
    """The federated mesh over the process group: ``size`` ranks (the
    world), this process being rank ``rank``, its tensors on ``device``.
    ``model`` ranks a client group (1: every rank a client shard);
    ``groups`` maps ``client``/``model`` to this rank's process groups
    (``None``: the default group).  Without a ``model`` group (the
    default) the mesh is the 1-D client mesh over ``group``."""

    def __init__(self, size: int, rank: int, device, group=None,
                 model: int = 1, groups: Optional[dict] = None):
        self.size = int(size)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.group = group
        self.model_size = int(model)
        self.client_size = self.size // self.model_size
        #: this rank's coordinates: rank = c_coord * model_size + m_coord
        self.c_coord = self.rank // self.model_size
        self.m_coord = self.rank % self.model_size
        self.groups = dict(groups or {CLIENT_AXIS: group})
        #: axis sizes, as ``jax.sharding.Mesh.shape`` reads
        self.shape = {a: 1 for a in ALL_AXES}
        self.shape[CLIENT_AXIS] = self.client_size
        self.shape[MODEL_AXIS] = self.model_size

    def __repr__(self):
        return (f"Mesh(client={self.client_size}, model={self.model_size}, "
                f"rank={self.rank}, device={self.device})")

    def _group(self, axis):
        """The process group of ``axis``: None or both axes name every
        rank; ``client`` or ``model`` this rank's group along it."""
        if axis is None or (isinstance(axis, (tuple, list))
                            and set(axis) == {CLIENT_AXIS, MODEL_AXIS}):
            return self.group
        if axis not in (CLIENT_AXIS, MODEL_AXIS):
            raise ValueError(f"mesh axis {axis!r}: the port's mesh has "
                             f"{CLIENT_AXIS!r} and {MODEL_AXIS!r}")
        if axis not in self.groups:
            raise ValueError(
                f"this mesh has no {axis!r} group (make it with "
                "make_mesh(model=...) or make_mesh2d)")
        return self.groups[axis]

    def axis_size(self, axis=None) -> int:
        if axis == CLIENT_AXIS:
            return self.client_size
        if axis == MODEL_AXIS:
            return self.model_size
        return self.size

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


def make_mesh(client: int = -1, stage: int = 1, data: int = 1,
              model: Optional[int] = None, seq: int = 1,
              device=None) -> Mesh:
    """The canonical federated mesh over the process group (made by
    :func:`init_world` when there is none): ``client × model`` ranks,
    rank = ``c_coord·model + m_coord``.  ``client=-1`` absorbs the ranks
    the model factor leaves; any other value must fill the world with it.
    ``device`` defaults to the card (``cuda:LOCAL_RANK``).  A ``model``
    factor given (1 too) makes both axes' groups, so the tensor-parallel
    code runs over a model group, of one rank at ``model=1``; without one
    the mesh is the 1-D client mesh over the world, with no model group."""
    for axis, n in ((STAGE_AXIS, stage), (DATA_AXIS, data),
                    (SEQ_AXIS, seq)):
        if int(n) > 1:
            raise NotImplementedError(
                f"mesh axis {axis!r} of size {n}: {_UNPORTED_AXES[axis]} "
                "is not ported (the port runs the client x model mesh)")
    two_axes = model is not None
    model = 1 if model is None else int(model)
    if model < 1:
        raise ValueError(f"model factor must be >= 1, got {model}")
    if device is None:
        from ..device import card_device
        device = card_device()
    init_world(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % model:
        raise ValueError(
            f"a model factor of {model} does not divide the {world} ranks "
            "of the process group")
    if int(client) not in (-1, world // model):
        raise ValueError(
            f"mesh wants {client} x {model} ranks, and the process group "
            f"has {world} (start them with torchrun or "
            "simulation.mesh.launch.spawn)")
    if not two_axes:
        return Mesh(world, rank, device)
    client_groups, model_groups = _axis_groups(world, world // model, model)
    groups = {CLIENT_AXIS: client_groups[rank % model],
              MODEL_AXIS: model_groups[rank // model]}
    return Mesh(world, rank, device, model=model, groups=groups)


def make_mesh2d(mesh_shape, device=None) -> Mesh:
    """The 2-D ``(client, model)`` mesh of ``mesh_shape`` (``"c,m"``,
    ``"cxm"`` or a pair; ``-1`` in the client slot takes the ranks the
    model factor leaves).  A 3-D shape with a stage factor above 1 raises
    by name (the pipeline layout is not ported)."""
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
