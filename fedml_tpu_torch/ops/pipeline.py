"""Pipeline parallelism (GPipe) over a mesh axis, and the collectives with
exact gradients it is built from (port of ``fedml_tpu.ops.pipeline``).

The JAX package writes these as ``custom_vjp`` functions inside a fully
manual ``shard_map``, where autodiff transposes each collective.  Here
each is a ``torch.autograd.Function`` over the port's mesh
(``core/mesh.py``), one process a rank, and ``loss.backward()`` on every
rank runs the transposed collectives in the same order on each:

- :func:`psum_keepgrad`: all-reduce forward, identity backward (closes a
  row-parallel matmul, and replicates a loss whose cotangent is the same
  on every rank);
- :func:`sumgrad`: identity forward, all-reduce backward (opens a sliced
  computation on a replicated activation: each rank's slice gives a
  partial cotangent, and the true one is their sum).  The pair is
  Megatron's f/g; the tensor-parallel Llama (``llm/model.py``) and the
  expert-parallel MoE use it over the ``model`` group;
- :func:`ppermute`: the ring shift ``i -> i + shift`` along an axis
  (:meth:`~fedml_tpu_torch.core.mesh.Mesh.ppermute`, one
  ``batch_isend_irecv``); its backward shifts the cotangent back, as
  JAX's transpose of ``ppermute`` does.  The pipeline schedule and ring
  attention (``ops/ring_attention.py``) both move their blocks with it.

:func:`pipeline_ticks` is the schedule: ``n_micro + n_stages - 1`` ticks,
stage 0 injecting microbatch ``t``, every stage applying its layers to
what it received the tick before and shifting the result one stage on.
A stage that ignores what it received keeps it in the graph through a
``torch.where`` (as the JAX schedule's ``jnp.where``), so every rank's
backward runs every tick's shift.  :func:`pipeline_apply` runs it over
stacked microbatches and returns the last stage's outputs; the mesh
engine's ``PipelineTrainer`` runs it with the embed injected on stage 0
and the head drained on the last.
"""

from __future__ import annotations

import torch

from ..core.mesh import MODEL_AXIS, STAGE_AXIS


class _PsumKeepGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.psum(x.contiguous(), axis=axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g.contiguous(), axis=ctx.axis), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return mesh.ppermute(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.ppermute(g, ctx.axis, -ctx.shift), None, None, None


def psum_keepgrad(x: torch.Tensor, mesh, axis=MODEL_AXIS) -> torch.Tensor:
    """All-reduce over ``axis`` with an identity backward: exact when the
    consumer's cotangent is the same on every rank of the axis."""
    return _PsumKeepGrad.apply(x, mesh, axis)


def sumgrad(x: torch.Tensor, mesh, axis=MODEL_AXIS) -> torch.Tensor:
    """Identity forward, all-reduce backward over ``axis``."""
    return _SumGrad.apply(x, mesh, axis)


def ppermute(x: torch.Tensor, mesh, axis=STAGE_AXIS,
             shift: int = 1) -> torch.Tensor:
    """The ring shift along ``axis``, differentiable: the cotangent
    travels the other way."""
    return _PPermute.apply(x, mesh, axis, shift)


def tp_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mesh,
             axis=MODEL_AXIS) -> torch.Tensor:
    """Row-parallel dense over ``axis``: ``x`` the replicated activation
    ``(..., in)``, ``w`` this rank's rows ``(in / k, out)``, ``b`` whole
    ``(out,)``.  Each rank multiplies its slice of ``x`` by its rows and
    :func:`psum_keepgrad` sums the partial products; :func:`sumgrad` on
    ``x`` sums the partial input cotangents.  Without a mesh (or over one
    rank) a plain dense."""
    if mesh is None or mesh.axis_size(axis) == 1:
        return x @ w + b
    x = sumgrad(x, mesh, axis)
    rows = w.shape[0]
    k = mesh.coord(axis)
    xs = x[..., k * rows:(k + 1) * rows]
    return psum_keepgrad(xs @ w, mesh, axis) + b


def pipeline_ticks(stage_fn, stage_params, inject, zeros: torch.Tensor,
                   n_micro: int, mesh, axis=STAGE_AXIS, first=None):
    """A stage's GPipe schedule: ``n_micro + n_stages - 1`` ticks, each
    applying ``stage_fn(stage_params, x)`` to what the stage received the
    tick before (stage 0: ``inject(t)``, its fresh input at tick ``t``,
    or None for ``zeros``) and shifting the result one stage on.  Yields
    ``(t, y)`` a tick.  ``zeros``: an activation's shape, what a stage
    holds before its first receive; ``first``: whether this rank is stage
    0, a bool device tensor (made here if None).  Without a mesh (or over
    one stage) the ticks run with no shift."""
    n = 1 if mesh is None else mesh.axis_size(axis)
    if first is None:
        first = torch.tensor(n == 1 or mesh.coord(axis) == 0,
                             device=zeros.device)
    state = zeros
    for t in range(n_micro + n - 1):
        fresh = inject(t)
        # stage 0 keeps what it received in the graph too, so the
        # shift's backward runs on every rank
        y = stage_fn(stage_params, torch.where(
            first, zeros if fresh is None else fresh, state))
        if n > 1:
            state = ppermute(y, mesh, axis)
        yield t, y


def pipeline_apply(stage_fn, stage_params, microbatches: torch.Tensor,
                   mesh, axis=STAGE_AXIS) -> torch.Tensor:
    """Run ``n_micro`` microbatches through the ``n_stages``-deep
    pipeline of ``axis`` (:func:`pipeline_ticks`).  ``stage_params``:
    this rank's stage; ``microbatches``: ``(n_micro, mb, ...)``, the same
    on every rank (only stage 0 reads it); ``stage_fn(params, x) -> y``
    keeps ``x``'s shape.  Returns the last stage's ``(n_micro, mb, ...)``
    outputs on every rank (a masked :func:`psum_keepgrad`: differentiate
    one copy of a loss of them, the same on every rank)."""
    n = mesh.axis_size(axis)
    me = mesh.coord(axis)
    n_micro = microbatches.shape[0]
    ys = [y for _, y in pipeline_ticks(
        stage_fn, stage_params,
        lambda t: microbatches[t] if t < n_micro else None,
        torch.zeros_like(microbatches[0]), n_micro, mesh, axis)]
    out = torch.stack(ys[n - 1:])
    return psum_keepgrad(out * float(me == n - 1), mesh, axis)


__all__ = ["pipeline_apply", "pipeline_ticks", "psum_keepgrad", "sumgrad", "ppermute",
           "tp_dense"]
