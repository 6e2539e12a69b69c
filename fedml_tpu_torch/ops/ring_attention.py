"""Ring attention: exact causal attention over a sequence sharded on the
mesh's ``seq`` group (port of ``fedml_tpu.ops.ring_attention``).

Each rank holds one Q shard and one K/V shard of ``S_local`` positions.
For ``n`` steps every rank attends its Q shard to the K/V shard it holds,
then shifts that shard one rank on (``Mesh.ppermute``): at step ``i`` it
holds the shard of rank ``src = (me - i) mod n``.  The JAX package
computes each step with plain einsums; here each step is one of the
port's hand-written kernels (:func:`ring_step`):

- ``src == me``: the diagonal block, K1 causal;
- ``src < me``: an earlier block, every position visible, K1 with
  ``causal=False``;
- ``src > me``: a later block, every position masked: skipped.

The partial outputs merge through their row log-sum-exps (``lse =
logaddexp(lse, lse_i)``, each O rescaled), in f32: each kernel writes its
partial result in f32 (``out_f32``; the C ``dtype`` 2 of a bf16 build),
so a bf16 ring rounds once, as one call over the whole sequence does.
The backward is a ring of its own (:class:`_RingAttention`): every step
runs K2 (dQ, Δ folded in) and K3 (dK, dV) against the GLOBAL O, lse and
dO, so each block's gradients are exact pieces of the whole; the dK/dV
accumulators ride the ring with their K/V shard and arrive home after
``n`` shifts.  Grouped-query heads use K1's head map (no repeated K/V).

:func:`ring_fwd` and :func:`ring_bwd` are a rank's loops over the ring,
written once: ``kv_at(i)`` hands them the K/V block of step ``i`` and
``deposit`` takes its dK/dV.  :class:`_RingAttention` gives them the
mesh's shifts (the block and the riding accumulators, ``Mesh.ppermute``);
:func:`ring_schedule_fwd` and :func:`ring_schedule_bwd` run every rank's
loops on one device, the exchange replaced by slicing (``plain=True``:
each step the kernels' plain versions).

:func:`ring_attention_plain` is the JAX recurrence step for step in
PyTorch (f32 scores, running max and sum, autograd through the shifts),
and :func:`ring_schedule_plain` its ``n`` ranks on one device: the CPU
tests hold the kernel ring to it and to the JAX package.  Its autograd
backward keeps dS in f32 where K2 and K3 round it to the operand type
before their products (as the TPU kernels do), so in bf16 one kernel
call over the whole sequence reads the same gap to it as the ring does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.mesh import SEQ_AXIS
from .attention import (NEG_INF, _scale, flash_attention_bwd_dkv,
                        flash_attention_bwd_dkv_plain, flash_attention_bwd_dq,
                        flash_attention_bwd_dq_plain, flash_attention_fwd,
                        flash_attention_fwd_plain)
from .pipeline import ppermute


def step_kind(me: int, src: int, causal: bool) -> str:
    """What step ``src``'s K/V block is to rank ``me``'s queries:
    ``"diag"``, ``"full"`` or ``"skip"``."""
    if not causal:
        return "full"
    if src == me:
        return "diag"
    return "full" if src < me else "skip"


def ring_step(q, k_blk, v_blk, carry, kind: str,
              sm_scale: Optional[float] = None, plain: bool = False):
    """One forward step: ``carry`` ``(o, lse)`` (f32 O, f32 lse; None
    before the first) merged with K1 on this block, its O written in f32
    (a partial output rounded to bf16 before the merge would carry its
    rounding into every later block's sum).  ``plain``: K1's plain version
    in its place.  Returns the new carry."""
    if kind == "skip":
        return carry
    fwd = flash_attention_fwd_plain if plain else flash_attention_fwd
    o_i, lse_i = fwd(q, k_blk, v_blk, kind == "diag", sm_scale, out_f32=True)
    if carry is None:
        return o_i, lse_i
    o, lse = carry
    new = torch.logaddexp(lse, lse_i)
    o = o * torch.exp(lse - new)[..., None] + \
        o_i * torch.exp(lse_i - new)[..., None]
    return o, new


def ring_step_bwd(q, k_blk, v_blk, o, lse, do, kind: str,
                  sm_scale: Optional[float] = None, plain: bool = False):
    """One backward step against the global ``o``, ``lse`` and ``do``:
    ``(dq_i, dk_i, dv_i)`` of this block by K2 and K3, written in f32
    (they are summed over the ring), or None for a skipped block.
    ``plain``: K2's and K3's plain versions in their place."""
    if kind == "skip":
        return None
    causal = kind == "diag"
    bwd_dq, bwd_dkv = (
        (flash_attention_bwd_dq_plain, flash_attention_bwd_dkv_plain)
        if plain else (flash_attention_bwd_dq, flash_attention_bwd_dkv))
    dq, delta = bwd_dq(q, k_blk, v_blk, o, lse, do, causal, sm_scale,
                       out_f32=True)
    dk, dv = bwd_dkv(q, k_blk, v_blk, lse, delta, do, causal, sm_scale,
                     out_f32=True)
    return dq, dk, dv


def ring_fwd(q, kv_at, me: int, n: int, causal: bool = True,
             sm_scale: Optional[float] = None, plain: bool = False):
    """Rank ``me``'s forward over a ring of ``n``: ``kv_at(i)`` is the
    ``(k, v)`` block it holds at step ``i`` (called once a step, in
    order: on a mesh it shifts the block on).  Returns the f32 carry
    ``(o, lse)``."""
    carry = None
    for i in range(n):
        k_blk, v_blk = kv_at(i)
        carry = ring_step(q, k_blk, v_blk, carry,
                          step_kind(me, (me - i) % n, causal), sm_scale,
                          plain)
    return carry


def ring_bwd(q, kv_at, deposit, o, lse, do, me: int, n: int,
             causal: bool = True, sm_scale: Optional[float] = None,
             plain: bool = False) -> torch.Tensor:
    """Rank ``me``'s backward ring against the global ``o``, ``lse`` and
    ``do``: ``kv_at`` as in :func:`ring_fwd`; ``deposit(i, got)`` takes
    step ``i``'s ``(dk_i, dv_i)`` of the block ``(me - i) mod n`` (None
    for a skipped block), once a step.  Returns dQ in f32."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for i in range(n):
        k_blk, v_blk = kv_at(i)
        got = ring_step_bwd(q, k_blk, v_blk, o, lse, do,
                            step_kind(me, (me - i) % n, causal), sm_scale,
                            plain)
        if got is not None:
            dq += got[0]
        deposit(i, None if got is None else got[1:])
    return dq


def _shifting(k, v, mesh, axis):
    """``kv_at`` on a mesh: the held K/V block, shifted one rank on
    before every step but the first."""
    held = [torch.stack([k, v])]

    def kv_at(i):
        if i:
            held[0] = mesh.ppermute(held[0], axis)
        return held[0][0], held[0][1]

    return kv_at


def _sliced(ks, vs, me: int, n: int):
    """``kv_at`` on one device: rank ``me``'s block at step ``i`` taken by
    indexing, the exchange replaced."""
    return lambda i: (ks[(me - i) % n], vs[(me - i) % n])


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, sm_scale):
        n = 1 if mesh is None else mesh.axis_size(axis)
        me = 0 if mesh is None else mesh.coord(axis)
        o, lse = ring_fwd(q, _shifting(k, v, mesh, axis), me, n, causal,
                          sm_scale)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mesh, ctx.axis, ctx.causal, ctx.sm_scale = (mesh, axis, causal,
                                                        sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        n = 1 if mesh is None else mesh.axis_size(axis)
        me = 0 if mesh is None else mesh.coord(axis)
        # the dK/dV accumulators ride the ring with their block: after n
        # shifts they are home
        acc = [torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                           device=q.device)]

        def deposit(i, got):
            if got is not None:
                acc[0][0] += got[0]
                acc[0][1] += got[1]
            if n > 1:
                acc[0] = mesh.ppermute(acc[0], axis)

        dq = ring_bwd(q, _shifting(k, v, mesh, axis), deposit, o, lse,
                      do.contiguous(), me, n, ctx.causal, ctx.sm_scale)
        dkv = acc[0]
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def ring_attention(q, k, v, mesh=None, axis=SEQ_AXIS, causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention of this rank's shard ``(B, H, S_local, D)`` of q over the
    whole sequence sharded on ``mesh``'s ``axis`` (k/v ``(B, H_kv,
    S_local, D)``, ``H_kv | H``), exact; the kernels on the card, their
    plain versions on the CPU.  Without a mesh (or over one rank) one
    diagonal K1 call."""
    return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), mesh, axis, causal, sm_scale)


def _plain_steps(q, kv_at, me: int, n: int, causal: bool,
                 sm_scale: Optional[float]):
    """The JAX ring's recurrence for rank ``me``'s queries: ``kv_at(i)``
    is the K/V block it holds at step ``i`` (grouped-query K/V repeated to
    the q heads, as the JAX model does before it calls the ring)."""
    s_local = q.shape[-2]
    sm_scale = _scale(q, sm_scale)
    dev = q.device
    q_pos = me * s_local + torch.arange(s_local, device=dev)
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=dev)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    for i in range(n):
        k_cur, v_cur = kv_at(i)
        if k_cur.shape[1] != q.shape[1]:
            rep = q.shape[1] // k_cur.shape[1]
            k_cur = k_cur.repeat_interleave(rep, dim=1)
            v_cur = v_cur.repeat_interleave(rep, dim=1)
        src = (me - i) % n
        kv_pos = src * s_local + torch.arange(s_local, device=dev)
        scores = (q.float() @ k_cur.float().transpose(-1, -2)) * sm_scale
        if causal:
            scores = torch.where(kv_pos[None, :] <= q_pos[:, None], scores,
                                 NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + \
            p.to(v_cur.dtype).float() @ v_cur.float()
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def ring_attention_plain(q, k, v, mesh=None, axis=SEQ_AXIS,
                         causal: bool = True,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """The JAX package's ring recurrence step for step (f32 scores
    masked by global positions, running max and sum, P cast to V's type
    for the P·V product), differentiable by autograd through the
    shifts."""
    n = 1 if mesh is None else mesh.axis_size(axis)
    me = 0 if mesh is None else mesh.coord(axis)
    held = [(k, v)]

    def kv_at(i):
        if i:
            held.append(tuple(ppermute(t, mesh, axis) for t in held[-1]))
        return held[-1]

    return _plain_steps(q, kv_at, me, n, causal, sm_scale)


def ring_schedule_plain(q, k, v, n: int, causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """The plain ring's ``n`` ranks on one device, each rank's K/V taken
    by slicing: the whole ``(B, H, S, D)`` output (differentiable)."""
    qs, ks, vs = (t.chunk(n, dim=-2) for t in (q, k, v))
    return torch.cat([_plain_steps(qs[me], _sliced(ks, vs, me, n), me, n,
                                   causal, sm_scale) for me in range(n)],
                     dim=-2)


def _blocks(t, n: int, dim: int = -2):
    return [c.contiguous() for c in t.chunk(n, dim=dim)]


def ring_schedule_fwd(q, k, v, n: int, causal: bool = True,
                      sm_scale: Optional[float] = None, plain: bool = False):
    """The ``n``-rank ring's forward on one device: every rank's
    :func:`ring_fwd`, its K/V taken by slicing.  ``(o, lse)`` of the whole
    ``(B, H, S, D)`` (S divisible by ``n``; ``plain``: each step K1's
    plain version)."""
    qs, ks, vs = _blocks(q, n), _blocks(k, n), _blocks(v, n)
    outs, lses = [], []
    for me in range(n):
        o, lse = ring_fwd(qs[me], _sliced(ks, vs, me, n), me, n, causal,
                          sm_scale, plain)
        outs.append(o.to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, dim=-2), torch.cat(lses, dim=-1)


def ring_schedule_bwd(q, k, v, o, lse, do, n: int, causal: bool = True,
                      sm_scale: Optional[float] = None, plain: bool = False):
    """The ring's backward on one device: every rank's :func:`ring_bwd`
    against the global ``o``, ``lse`` and ``do``, each block's dK/dV
    summed over the ranks that attended it, in the order the riding
    accumulators meet them.  ``(dq, dk, dv)`` (``plain``: each step K2's
    and K3's plain versions)."""
    qs, ks, vs = _blocks(q, n), _blocks(k, n), _blocks(v, n)
    os_, ls, ds = _blocks(o, n), _blocks(lse, n, -1), _blocks(do, n)
    dk = [torch.zeros(c.shape, dtype=torch.float32, device=q.device)
          for c in ks]
    dv = [torch.zeros_like(c) for c in dk]
    dq = []
    for me in range(n):
        def deposit(i, got, me=me):
            if got is not None:
                dk[(me - i) % n] += got[0]
                dv[(me - i) % n] += got[1]

        dq.append(ring_bwd(qs[me], _sliced(ks, vs, me, n), deposit, os_[me],
                           ls[me], ds[me], me, n, causal, sm_scale, plain))
    cat = lambda xs, like: torch.cat(xs, dim=-2).to(like.dtype)
    return cat(dq, q), cat(dk, k), cat(dv, v)


__all__ = ["ring_attention", "ring_attention_plain", "ring_fwd", "ring_bwd",
           "ring_step", "ring_step_bwd", "ring_schedule_fwd",
           "ring_schedule_bwd", "ring_schedule_plain", "step_kind"]
