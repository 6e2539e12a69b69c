"""Decentralized FL (DSGD) over the mesh: ring gossip as neighbour
send/recv (port of ``fedml_tpu.simulation.mesh.decentralized_mesh``).

The sp engine (``simulation/sp/decentralized.py``) mixes the stacked
client models with one dense ``einsum`` ``x ← W x`` per leaf.  For the
ring (each client mixes with its ±1 neighbours, the default
``SymmetricTopologyManager(n, 2)``), clients shard over the ranks in
contiguous blocks, mixing inside a block is a shift, and only each
block's two boundary clients cross ranks: one ``batch_isend_irecv`` of
ghost rows each way a round (the JAX package's two ``ppermute``\\ s),
moving one model per neighbour instead of every model.  A world of 1
closes the ring on itself.  Push-sum (the asymmetric topology) has no
ring form and is refused, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ...core import rng as rng_util
from ...core.mesh import make_mesh
from .layout import refuse_model_factor
from ..round_engine import next_pow2
from ..sp.decentralized import DecentralizedFedAPI


class MeshDecentralizedAPI(DecentralizedFedAPI):
    """Ring DSGD with clients sharded over the mesh's client axis.

    Requires ``topology="symmetric"`` with 2 neighbours (the ring) and
    ``client_num_in_total`` divisible by the client-axis size.  ``params``
    holds this rank's block of clients."""

    def __init__(self, args, device, dataset, model, mesh=None):
        refuse_model_factor(args, mesh, "MeshDecentralizedAPI")
        topo = str(getattr(args, "topology", "symmetric")).lower()
        nbrs = int(getattr(args, "topology_neighbors", 2))
        if topo != "symmetric" or nbrs != 2:
            raise ValueError(
                "MeshDecentralizedAPI implements the ring (symmetric, 2 "
                f"neighbors) gossip as send/recv; got topology={topo!r} "
                f"neighbors={nbrs}: use the sp engine for dense mixing")
        if int(getattr(args, "client_num_in_total", 0)) < 3:
            raise ValueError(
                "ring gossip needs client_num_in_total >= 3 (below that "
                "the two neighbour ghosts coincide and the mix is no longer "
                "the sp engine's convex combination)")
        super().__init__(args, mesh.device if mesh is not None else device,
                         dataset, model)
        self.mesh = mesh if mesh is not None else make_mesh(
            client=-1, device=self.device)
        shards = self.mesh.size
        if self.n % shards != 0:
            raise ValueError(
                f"client_num_in_total={self.n} must divide over the "
                f"{shards}-way client mesh axis")
        self.per_shard = self.n // shards
        self.rows = slice(self.mesh.rank * self.per_shard,
                          (self.mesh.rank + 1) * self.per_shard)
        # the ring row of SymmetricTopologyManager(n, 2): self, then ±1
        row0 = self.W[0, :2].tolist()
        self.w_self, self.w_nbr = float(row0[0]), float(row0[1])
        self.params = {k: v[self.rows].clone()
                       for k, v in self.params.items()}

    def _ghosts(self, lf: torch.Tensor):
        """(left, right) neighbour rows of this block's ends: the previous
        rank's last client and the next rank's first."""
        size, rank = self.mesh.size, self.mesh.rank
        if size == 1:
            return lf[-1:], lf[:1]
        nxt, prv = (rank + 1) % size, (rank - 1) % size
        left, right = torch.empty_like(lf[:1]), torch.empty_like(lf[:1])
        ops = [dist.P2POp(dist.isend, lf[-1:].contiguous(), nxt,
                          self.mesh.group, 0),
               dist.P2POp(dist.isend, lf[:1].contiguous(), prv,
                          self.mesh.group, 1),
               dist.P2POp(dist.irecv, left, prv, self.mesh.group, 0),
               dist.P2POp(dist.irecv, right, nxt, self.mesh.group, 1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return left, right

    def _mix(self, trained):
        """``w_self·x_i + w_nbr·(x_{i-1} + x_{i+1})`` over the ring, every
        leaf packed into one row per client so a round sends one ghost row
        each way."""
        names = list(trained)
        lf = torch.cat([trained[k].reshape(self.per_shard, -1)
                        .to(torch.float32) for k in names], dim=1)
        left, right = self._ghosts(lf)
        ext = torch.cat([left, lf, right])
        mixed = self.w_self * lf + self.w_nbr * (ext[:-2] + ext[2:])
        out, off = {}, 0
        for k in names:
            n = trained[k][0].numel()
            out[k] = mixed[:, off:off + n].reshape(trained[k].shape).to(
                trained[k].dtype)
            off += n
        return out

    def train_one_round(self, round_idx: int):
        clients = np.arange(self.n)
        x, y, mask, _ = self.dataset.cohort_batches(
            clients, self.batch_size, self.seed, round_idx, self.epochs)
        pad = next_pow2(x.shape[1]) - x.shape[1]
        if pad:
            x = np.pad(x, [(0, 0), (0, pad)] + [(0, 0)] * (x.ndim - 2))
            y = np.pad(y, [(0, 0), (0, pad)] + [(0, 0)] * (y.ndim - 2))
            mask = np.pad(mask, [(0, 0), (0, pad)])
        x, y, mask = (torch.as_tensor(a[self.rows], device=self.device)
                      for a in (x, y, mask))
        gen = rng_util.round_key(self._root, round_idx)
        # every rank draws the whole ring's masks, as the sp engine does,
        # and keeps its block
        drop = (tuple(d[self.rows] for d in self.model.dropout_masks(
            gen, (self.n,) + tuple(x.shape[1:3])))
            if self.model.has_dropout else None)
        outs = self._clients(self.params, x, y, mask, drop)
        self.params = self._mix(outs["params"])
        loss = self.mesh.psum(torch.mean(outs["loss"])) / self.mesh.size
        return {"train_loss": loss}

    def consensus_params(self):
        """The average over every client of the ring (the ring is doubly
        stochastic, so no push-sum weight)."""
        w = torch.full((self.per_shard,), 1.0 / self.n, device=self.device)
        return {k: self.mesh.psum(torch.tensordot(
            w, l.to(torch.float32), dims=1)).to(l.dtype)
            for k, l in self.params.items()}

    def full_params(self):
        """Every client's params, ``(n, ...)`` (a collective)."""
        return {k: self.mesh.all_gather(v) for k, v in self.params.items()}


__all__ = ["MeshDecentralizedAPI"]
