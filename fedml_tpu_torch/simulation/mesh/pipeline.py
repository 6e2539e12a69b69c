"""Microbatched pipeline client training: the 3-D mesh's train phase
(port of ``fedml_tpu.simulation.mesh.pipeline``).

On the ``client × stage × model`` layout (``layout.py``) the model's
staged leaves split their layer axis over ``stage`` (and their rows over
``model``), and a client's train step is a GPipe schedule over the ranks
of its client shard:

- ``n_micro + n_stages - 1`` ticks, a Python loop
  (``ops/pipeline.py::pipeline_ticks``; the JAX body is a ``lax.scan``);
  stage 0 injects microbatch ``t`` while the schedule fills, the last
  stage drains microbatch ``t - (n_stages - 1)`` into a
  ``1/n_micro``-weighted cross-entropy;
- every tick each stage shifts its activation one stage on
  (``ops/pipeline.py::ppermute``, a ``torch.autograd.Function``), whose
  backward moves the activation-gradients the other way;
- the layers run row-parallel over ``model`` (``tp_dense``).

The gradient is one ``torch.autograd.grad`` of this rank's share of the
loss; the non-staged leaves' gradients are then summed over the stage
group (the backward of the JAX package's ``sumgrad``: embed is used on
stage 0 only, the head on the last stage only) and the loss replicated
over it (the forward of ``psum_keepgrad``).  Everything after the
gradient (the client optimizer, SCAFFOLD's correction, the step mask) is
:class:`LocalTrainer`'s, elementwise on this rank's shards.

The per-microbatch losses, each weighted ``1/n_micro`` over equal
microbatches, sum to the full-batch mean, so microbatching changes only
the order of the f32 sums.
"""

from __future__ import annotations

import torch

from ...core import federated
from ...core.mesh import STAGE_AXIS
from ...ml.trainer.local_trainer import (LocalTrainer, accuracy,
                                         cross_entropy_loss)
from ...ops.pipeline import pipeline_ticks

#: client algorithms whose loss adds a global parameter-norm term, which
#: does not decompose over stage/model shards
UNSUPPORTED_ALGS = ("fedprox", "feddyn")


class PipelineTrainer(LocalTrainer):
    """:class:`LocalTrainer` whose gradient is the microbatched pipeline's
    over ``layout``'s mesh.  The clients of a round run one after another
    (:func:`make_pipeline_cohort`): each step's collectives span the ranks
    of the client shard."""

    def __init__(self, model, args, layout, microbatches: int = 1,
                 algorithm=None):
        super().__init__(model, args, algorithm)
        if model.pipeline is None:
            raise ValueError(
                "the pipeline layout needs a staged model "
                "(TorchModel.pipeline is None): use model='pipe_mlp' or "
                "any model carrying a PipelineDef")
        if self.algorithm in UNSUPPORTED_ALGS:
            raise ValueError(
                f"federated_optimizer={self.algorithm!r} is incompatible "
                "with the pipeline layout: its loss regularizer needs a "
                "global parameter norm")
        if model.task != "classification":
            raise NotImplementedError(
                f"the pipeline loss is the classification cross-entropy; "
                f"task {model.task!r} is not ported to it")
        self.pipe = model.pipeline
        self.mesh = layout.mesh
        self.n_stages = int(layout.n_stage_shards)
        self.n_micro = int(microbatches)
        self.staged = set(self.pipe.stage_leaves)
        #: the model group the layers split their rows over (None: whole)
        self.tp_mesh = self.mesh if layout.n_model_shards > 1 else None

    def _is_first(self, me: int, device) -> torch.Tensor:
        """Whether this rank is stage 0, as a device tensor made once (a
        round replayed as a CUDA graph copies nothing from the host)."""
        key = (me, str(device))
        if getattr(self, "_first", (None,))[0] != key:
            self._first = (key, torch.tensor(me == 0, device=device))
        return self._first[1]

    def pipeline_loss(self, params, x, y):
        """This rank's share of the loss and accuracy of one batch (the
        last stage's ``1/n_micro``-weighted sums, zero elsewhere), and the
        root to differentiate: the loss plus zero times the last tick's
        activation, which reaches every tick's shift on every stage."""
        pd, mesh = self.pipe, self.mesh
        n_stages, n_micro = self.n_stages, self.n_micro
        me = mesh.coord(STAGE_AXIS) if n_stages > 1 else 0
        last = me == n_stages - 1
        mb = x.shape[0] // n_micro
        xm = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
        ym = y.reshape((n_micro, mb) + tuple(y.shape[1:]))
        state = torch.zeros((mb, pd.hidden), dtype=torch.float32,
                            device=x.device)
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        acc = torch.zeros((), dtype=torch.float32, device=x.device)
        inject = lambda t: pd.embed(params, xm[t]) \
            if me == 0 and t < n_micro else None
        for t, h in pipeline_ticks(
                lambda p, a: pd.blocks(p, a, self.tp_mesh), params, inject,
                state, n_micro, mesh if n_stages > 1 else None, STAGE_AXIS,
                self._is_first(me, x.device)):
            if last and t >= n_stages - 1:
                logits = pd.head(params, h)
                labels = ym[t - (n_stages - 1)]
                loss = loss + cross_entropy_loss(logits, labels) / n_micro
                acc = acc + accuracy(logits, labels).detach() / n_micro
        return loss, acc, loss + (h * 0.0).sum()

    def grad_and_loss(self, params, x, y, dropout_masks=None, ctx=None,
                      client_state=None):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss, _, root = self.pipeline_loss(leaves, x, y)
            got = torch.autograd.grad(root, list(leaves.values()),
                                      allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), got)}
        loss = loss.detach()
        if self.n_stages > 1:
            names = [k for k in grads if k not in self.staged]
            summed = self.mesh.psum_many([grads[k] for k in names] + [loss],
                                         axis=STAGE_AXIS)
            grads.update(zip(names, summed[:-1]))
            loss = summed[-1]
        return grads, loss


def make_pipeline_cohort(trainer: PipelineTrainer, spec, server_opt
                         ) -> federated.RoundProgram:
    """The cohort train phase on the pipeline layout: the round program
    running its clients one after another (``scan``), each step a
    pipeline over the client shard's ranks."""
    return federated.RoundProgram(spec, trainer.make_local_train(),
                                  server_opt, "scan")


def check_pipeline_shapes(model, layout, batch_size: int,
                          microbatches: int) -> None:
    """The static divisibility contract of the pipeline layout, raised
    when the engine is built, naming the knobs."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if batch_size % microbatches:
        raise ValueError(
            f"batch_size={batch_size} must divide by "
            f"microbatches={microbatches} (equal microbatches keep the "
            f"pipelined loss exactly the full-batch mean)")
    pd = model.pipeline
    s, m = layout.n_stage_shards, layout.n_model_shards
    for name in pd.stage_leaves:
        shape = tuple(model.module.get_parameter(name).shape)
        if shape[0] % s:
            raise ValueError(
                f"staged leaf {name!r} depth {shape[0]} must divide by "
                f"n_stage_shards={s} (contiguous layer chunks per stage)")
        if len(shape) >= 3 and shape[1] % m:
            raise ValueError(
                f"staged leaf {name!r} row dim {shape[1]} must divide by "
                f"n_model_shards={m} (row-parallel blocks)")


def validate_pipeline_args(args) -> None:
    """The pipeline gate of the JAX package's ``validate_args``: a stage
    factor above 1 (a 3-tuple ``mesh_shape`` or ``mesh_stage``) refuses a
    population, FedBuff, ``cohort_bucketing``, FedProx, FedDyn and
    ``microbatches`` that do not divide ``batch_size``, naming the flag.
    Raises ``ValueError``."""
    from ...core.mesh import parse_mesh_shape
    shape = getattr(args, "mesh_shape", None)
    stages = 1
    parsed = parse_mesh_shape(shape) if shape is not None else None
    if parsed is not None and len(parsed) == 3:
        stages = int(parsed[1])
    stages = max(stages, int(getattr(args, "mesh_stage", 1) or 1))
    if stages <= 1:
        return
    alg = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
    src = "mesh_shape" if shape is not None else "mesh_stage"
    bad = [flag for flag, on in (
        ("population", int(getattr(args, "population", 0) or 0) > 1
         or bool(getattr(args, "population_axes", None))),
        ("federated_optimizer=fedbuff", alg == "fedbuff"),
        ("cohort_bucketing", bool(getattr(args, "cohort_bucketing", False))),
    ) if on]
    if bad:
        raise ValueError(
            f"incompatible flags: {src} with n_stage_shards={stages} + "
            f"{' + '.join(bad)}: the pipeline train phase runs a fixed "
            "cohort of clients in lockstep over the stage ring; population "
            "maps, buffered-async applies and data-dependent bucket shapes "
            "cannot ride it")
    if alg in UNSUPPORTED_ALGS:
        raise ValueError(
            f"incompatible flags: {src} with n_stage_shards={stages} + "
            f"federated_optimizer={alg}: its loss adds a global "
            "parameter-norm regularizer, which does not decompose over "
            "stage/model shards")
    micro = int(getattr(args, "microbatches", 1) or 1)
    bsz = int(getattr(args, "batch_size", 10) or 10)
    if micro < 1 or bsz % micro:
        raise ValueError(
            f"incompatible flags: microbatches={micro} must be >= 1 and "
            f"divide batch_size={bsz}: equal microbatches keep the "
            "pipelined loss exactly the full-batch mean")


__all__ = ["PipelineTrainer", "make_pipeline_cohort",
           "check_pipeline_shapes", "validate_pipeline_args",
           "UNSUPPORTED_ALGS"]
