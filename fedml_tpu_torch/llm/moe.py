"""Mixture-of-Experts SwiGLU FFN, single device (port of
``fedml_tpu.llm.moe.MoEMLP``).

- **Router**: an f32 ``Dense(E)`` without bias on the f32 input, softmax,
  top-k, the k gates renormalised by ``max(sum, 1e-9)``.
- **Dispatch**: capacity-limited one-hot dispatch and combine tensors
  ``(N, E, C)`` with ``C = max(1, int(capacity_factor·k·N/E))``.  A token's
  slot in an expert's queue is its prefix count there, and the queue depth
  is SHARED across the k branches (two branches never land in one slot).
  A token over capacity is dropped: its combine weight is zero.
- **Experts**: the einsums run in ``dtype``; the combine runs in f32.

The load-balancing value the JAX module sows into ``"losses"`` (the switch
loss ``E²·Σ mean-prob · token-fraction``) is returned by
:meth:`MoEMLP.forward_with_aux`; no trainer reads it, in either package.

Every one-hot is a comparison with ``arange`` (no ``F.one_hot``, whose
range check reads the data), so the module runs under ``torch.func.vmap``.

``mesh`` (a ``core.mesh.Mesh``) is expert parallelism over its model group,
the counterpart of the JAX module's ``_ep_constraint``: each rank holds
``E/m`` experts, routes every token exactly as without a mesh (the router
is whole on every rank), computes its experts' slots of the dispatch and
their share of the combine, and the group sums the shares.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


class MoEMLP(nn.Module):
    """Drop-in SwiGLU FFN with ``n_experts`` experts, top-k routed.
    Parameters (flax names): ``router.kernel`` ``(dim, E)`` f32, ``w_gate``
    and ``w_up`` ``(E, dim, ffn)``, ``w_down`` ``(E, ffn, dim)`` in
    ``param_dtype``, frozen as the model's ``Dense`` layers are."""

    #: how the model hub initialises the bare expert kernels
    flax_kinds = {"w_gate": "kernel", "w_up": "kernel", "w_down": "kernel"}

    def __init__(self, dim: int, ffn_dim: int, n_experts: int = 8,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype: Any = torch.float32,
                 param_dtype: Any = torch.float32,
                 mesh: Optional[Any] = None):
        super().__init__()
        from .model import Dense, _TP
        self.tp = None if mesh is None else _TP(mesh)
        if self.tp is not None and n_experts % self.tp.size:
            raise NotImplementedError(
                f"MoEMLP(mesh=...): a model factor of {self.tp.size} does "
                f"not divide n_experts={n_experts}")
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router = Dense(dim, n_experts, torch.float32, torch.float32)
        mk = lambda *shape: nn.Parameter(
            torch.empty(shape, dtype=param_dtype), requires_grad=False)
        #: this rank's experts
        self.experts = slice(0, n_experts) if self.tp is None else \
            self.tp.part(n_experts)
        e_local = self.experts.stop - self.experts.start
        self.w_gate = mk(e_local, dim, ffn_dim)
        self.w_up = mk(e_local, dim, ffn_dim)
        self.w_down = mk(e_local, ffn_dim, dim)
        if self.tp is not None:
            self.tp_split = {"w_gate": 0, "w_up": 0, "w_down": 0}

    def capacity(self, n_tok: int) -> int:
        """Slots an expert takes: ``max(1, int(capacity_factor·k·N/E))``,
        ``int`` truncating as Python's does."""
        return max(1, int(self.capacity_factor * self.top_k * n_tok
                          / self.n_experts))

    def forward(self, x):
        return self.forward_with_aux(x)[0]

    def forward_with_aux(self, x):
        """``(out, aux)``: the FFN output in ``x.dtype`` and the f32
        load-balancing value."""
        from .model import copy_to_model, reduce_from_model
        b, s, dim = x.shape
        n_tok = b * s
        e, k = self.n_experts, self.top_k
        cap = self.capacity(n_tok)

        xt = copy_to_model(x, self.tp).reshape(n_tok, dim).float()
        probs = torch.softmax(self.router(xt), dim=-1)          # (N, E)
        gate_vals, gate_idx = torch.topk(probs, k, dim=-1)      # (N, k)
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(-1, keepdim=True), 1e-9)

        me = probs.mean(0)                                      # prob fraction
        ce = _one_hot(gate_idx, e).sum((0, 1)) / (n_tok * k)    # token fraction
        aux = (me * ce).sum() * e * e

        disp = xt.new_zeros((n_tok, e, cap))
        comb = xt.new_zeros((n_tok, e, cap))
        base = xt.new_zeros((e,))       # queue depth shared across branches
        for j in range(k):
            onehot = _one_hot(gate_idx[:, j], e)                # (N, E)
            pos = torch.cumsum(onehot, 0) - onehot + base[None, :]
            posj = pos.gather(1, gate_idx[:, j:j + 1])[:, 0]
            keep = (posj < cap).float()
            slot = _one_hot(posj.long(), cap) * keep[:, None]
            contrib = onehot[:, :, None] * slot[:, None, :]
            disp = disp + contrib
            comb = comb + contrib * gate_vals[:, j][:, None, None]
            base = base + onehot.sum(0)

        if self.tp is not None:
            disp, comb = disp[:, self.experts], comb[:, self.experts]
        expert_in = torch.einsum("nec,nd->ecd", disp, xt).to(self.dtype)
        h = torch.einsum("ecd,edf->ecf", expert_in, self.w_gate.to(self.dtype))
        u = torch.einsum("ecd,edf->ecf", expert_in, self.w_up.to(self.dtype))
        y = torch.einsum("ecf,efd->ecd", F.silu(h) * u,
                         self.w_down.to(self.dtype))
        out = reduce_from_model(torch.einsum("nec,ecd->nd", comb, y.float()),
                                self.tp)
        return out.reshape(b, s, dim).to(x.dtype), aux


@torch.no_grad()
def moe_per_token(moe: MoEMLP, x: torch.Tensor) -> torch.Tensor:
    """Plain version of :meth:`MoEMLP.forward`: the router as the module's,
    then the slots assigned by a host loop over the k branches and the
    tokens in order (one count per expert, shared by the branches; a token
    past ``capacity`` is dropped), then each expert's SwiGLU over the rows
    it took, in ``moe.dtype``, summed into an f32 output by gate weight."""
    b, s, dim = x.shape
    n, e, k = b * s, moe.n_experts, moe.top_k
    cap = moe.capacity(n)
    xt = x.reshape(n, dim).float()
    probs = torch.softmax(xt @ moe.router.kernel.float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    chosen = gate_idx.cpu().numpy()
    counts = [0] * e
    taken = [([], []) for _ in range(e)]       # (token, branch) per expert
    for j in range(k):
        for t in range(n):
            ex = int(chosen[t, j])
            if counts[ex] < cap:
                taken[ex][0].append(t)
                taken[ex][1].append(j)
            counts[ex] += 1
    out = torch.zeros((n, dim), device=x.device)
    for ex, (toks, branch) in enumerate(taken):
        if not toks:
            continue
        t = torch.tensor(toks, device=x.device)
        j = torch.tensor(branch, device=x.device)
        xe = xt[t].to(moe.dtype)
        h = xe @ moe.w_gate[ex].to(moe.dtype)
        u = xe @ moe.w_up[ex].to(moe.dtype)
        y = (F.silu(h) * u) @ moe.w_down[ex].to(moe.dtype)
        out.index_add_(0, t, y.float() * gate_vals[t, j][:, None])
    return out.reshape(b, s, dim).to(x.dtype)
