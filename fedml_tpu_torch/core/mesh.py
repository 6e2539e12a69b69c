"""The federated mesh over a ``torch.distributed`` process group (port of
``fedml_tpu.core.mesh``).

The JAX package names five mesh axes (``client``, ``stage``, ``data``,
``model``, ``seq``) over the devices of one controller.  Here one process
runs per rank and the mesh is the process group: the ``client`` axis is
the world, each rank one client shard.  Only the 1-D layout is ported:
a factor above 1 on any other axis raises ``NotImplementedError`` naming
it.

:class:`Mesh` carries the rank, the world size, the group and the device,
and the three collectives the engines use (an all-reduce, a reduce-scatter
and an all-gather), written to run on both torch builds the port meets
(``reduce_scatter_single``/``all_gather_single`` where they exist, the
older ``*_tensor`` names otherwise).  On the card the group is NCCL; on
the CPU it is gloo.  A world of 1 still runs every collective (a copy), so
the card's single-rank run goes through NCCL.

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
    MODEL_AXIS: "the 2-D client x model layout (tensor parallelism)",
    SEQ_AXIS: "sequence parallelism (ring attention)",
}


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
    gc.collect()
    if "nccl" in str(dist.get_backend()).lower():
        torch.cuda.synchronize()
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
    dist.destroy_process_group()


class Mesh:
    """The 1-D client mesh: ``size`` client shards, one per rank of
    ``group`` (``None``: the default group), this process being shard
    ``rank``, its tensors on ``device``."""

    def __init__(self, size: int, rank: int, device, group=None):
        self.size = int(size)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.group = group
        #: axis sizes, as ``jax.sharding.Mesh.shape`` reads
        self.shape = {a: 1 for a in ALL_AXES}
        self.shape[CLIENT_AXIS] = self.size

    def __repr__(self):
        return (f"Mesh(client={self.size}, rank={self.rank}, "
                f"device={self.device})")

    # -- collectives ---------------------------------------------------------
    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the client axis (a new tensor)."""
        out = t.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def psum_scatter(self, vec: torch.Tensor) -> torch.Tensor:
        """This shard's contiguous chunk of the sum of ``vec`` over the
        client axis (``vec``'s length divides by the shard count)."""
        out = torch.empty(vec.shape[0] // self.size, dtype=vec.dtype,
                          device=vec.device)
        fn = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        fn(out, vec.contiguous(), group=self.group)
        return out

    def all_gather(self, chunk: torch.Tensor) -> torch.Tensor:
        """The shards' chunks concatenated along dim 0, in rank order."""
        out = torch.empty((self.size * chunk.shape[0],) +
                          tuple(chunk.shape[1:]), dtype=chunk.dtype,
                          device=chunk.device)
        fn = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        fn(out, chunk.contiguous(), group=self.group)
        return out


def make_mesh(client: int = -1, stage: int = 1, data: int = 1,
              model: int = 1, seq: int = 1, device=None) -> Mesh:
    """The canonical federated mesh over the process group (made by
    :func:`init_world` when there is none).  ``client=-1`` takes the whole
    world; any other value must equal it.  ``device`` defaults to the
    card (``cuda:LOCAL_RANK``)."""
    for axis, n in ((STAGE_AXIS, stage), (DATA_AXIS, data),
                    (MODEL_AXIS, model), (SEQ_AXIS, seq)):
        if int(n) > 1:
            raise NotImplementedError(
                f"mesh axis {axis!r} of size {n}: {_UNPORTED_AXES[axis]} "
                "is not ported (the port runs the 1-D client mesh)")
    if device is None:
        from ..device import card_device
        device = card_device()
    init_world(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if int(client) not in (-1, world):
        raise ValueError(
            f"mesh wants {client} client shards, and the process group has "
            f"{world} ranks (start {client} ranks: torchrun or "
            "simulation.mesh.launch.spawn)")
    return Mesh(world, rank, device)


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
