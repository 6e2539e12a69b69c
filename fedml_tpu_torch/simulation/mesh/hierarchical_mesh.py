"""Hierarchical FL over the mesh (port of
``fedml_tpu.simulation.mesh.hierarchical_mesh``): one group a rank.

The sp engine (``simulation/sp/hierarchical_fl.py``) loops over the
groups in Python.  Here rank ``g`` runs group ``g``'s ``group_comm_round``
inner rounds of group-local FedAvg (the sp engine's round function, with
its per-(inner round, group) generator, so the numbers are the sp
engine's) with no traffic between ranks, and only the global merge
crosses them: one all-reduce of the weighted group params packed with
the group weight and the weighted loss.  Gated to the weighted-average
group update (FedAvg), as in the JAX package.
"""

from __future__ import annotations

import torch

from ...core import rng as rng_util
from ...core.mesh import make_mesh
from .layout import refuse_model_factor
from ..sp.hierarchical_fl import HierarchicalFedAvgAPI


class MeshHierarchicalAPI(HierarchicalFedAvgAPI):
    """Two-level hierarchical FedAvg with one group per rank: ``group_num``
    must equal the mesh's client-axis size."""

    def __init__(self, args, device, dataset, model, mesh=None):
        refuse_model_factor(args, mesh, "MeshHierarchicalAPI")
        if str(getattr(args, "federated_optimizer", "FedAvg")).lower() not in \
                ("fedavg", "fedprox"):
            raise ValueError(
                "MeshHierarchicalAPI implements the weighted-average group "
                "update (FedAvg/FedProx); other optimizers keep server "
                "state per group: use the sp hierarchical engine")
        super().__init__(args, mesh.device if mesh is not None else device,
                         dataset, model)
        self.mesh = mesh if mesh is not None else make_mesh(
            client=-1, device=self.device)
        if self.mesh.size != self.group_num:
            raise ValueError(
                f"group_num={self.group_num} must equal the mesh's client "
                f"axis size {self.mesh.size}")

    def train_one_round(self, round_idx: int):
        clients = self._client_sampling(round_idx)
        g = self.mesh.rank
        members = clients[self._group_of(clients) == g]
        params = self.state.global_params
        dev = self.device
        w_g = torch.zeros((), device=dev)
        loss_w = torch.zeros((), device=dev)
        for inner in range(self.group_comm_round):
            if len(members) == 0:
                break
            inner_round = round_idx * self.group_comm_round + inner
            gen = rng_util.round_key(self._root, inner_round * 131 + g)
            state_g = self.state.replace(global_params=params)
            if hasattr(self, "_dev_x"):
                idx, mask, w = self.dataset.cohort_indices(
                    members, self.batch_size, self.seed, inner_round,
                    self.epochs)
                state_g, metrics, _ = self.round_fn(
                    state_g, *self._to_device(idx, mask, w), gen, None)
            else:
                x, y, mask, w = self.dataset.cohort_batches(
                    members, self.batch_size, self.seed, inner_round,
                    self.epochs)
                state_g, metrics, _ = self.round_fn(
                    state_g, *self._to_device(x, y, mask, w), gen, None)
            params = state_g.global_params
            w_g = torch.sum(torch.as_tensor(w, device=dev))
            loss_w = metrics["train_loss"] * w_g
        # the one cross-rank collective: the weighted group params, the
        # group weight and the weighted loss in one all-reduce
        names = list(params)
        summed = self.mesh.psum(torch.cat(
            [(params[k].to(torch.float32) * w_g).reshape(-1) for k in names]
            + [torch.stack([w_g, loss_w])]))
        total = torch.clamp_min(summed[-2], 1e-12)
        merged, off = {}, 0
        for k in names:
            n = params[k].numel()
            merged[k] = (summed[off:off + n].reshape(params[k].shape)
                         / total).to(params[k].dtype)
            off += n
        self.state = self.state.replace(global_params=merged,
                                        round_idx=self.state.round_idx + 1)
        return {"train_loss": summed[-1] / total}


__all__ = ["MeshHierarchicalAPI"]
