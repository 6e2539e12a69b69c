"""PipeMLP: the layer-stacked model of the pipeline layout (port of
``fedml_tpu.models.pipe_mlp``).

An embedding dense, ``depth`` uniform ``hidden × hidden`` relu blocks held
as ONE stacked ``blocks_w (depth, hidden, hidden)`` and ``blocks_b
(depth, hidden)`` parameter (the layer axis on dim 0, so a stage can own a
contiguous chunk of layers, and ``blocks_w`` in flax's ``(in, out)``
layout, so dim 1 is the row dim a model group splits), and an output
head.  The module's forward and the :class:`~.base.PipelineDef` split
functions are the same functions (``relu(x W_e + b_e)``, then ``relu(h W_l
+ b_l)`` per layer, then ``h W_h + b_h``), so the sp engine, the 2-D mesh
and the pipeline of ``simulation/mesh/pipeline.py`` compute one model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pipeline import tp_dense
from .base import PipelineDef, TorchModel


def _embed(params, x):
    x = x.reshape(x.shape[0], -1)
    return F.relu(F.linear(x, params["embed.weight"], params["embed.bias"]))


def _blocks(params, h, mesh=None):
    """This rank's stacked layers applied in order; each row-parallel
    over ``mesh``'s model group (``tp_dense``), plain without one."""
    w, b = params["blocks_w"], params["blocks_b"]
    for layer in range(w.shape[0]):
        h = F.relu(tp_dense(h, w[layer], b[layer], mesh))
    return h


def _head(params, h):
    return F.linear(h, params["head.weight"], params["head.bias"])


class PipeMLP(nn.Module):
    #: blocks_w keeps flax's (depth, in, out) layout; blocks_b is a bias
    flax_kinds = {"blocks_w": "kernel", "blocks_b": "bias"}

    def __init__(self, in_features: int, hidden: int, depth: int,
                 output_dim: int):
        super().__init__()
        self.embed = nn.Linear(in_features, hidden)
        self.blocks_w = nn.Parameter(torch.empty(depth, hidden, hidden))
        self.blocks_b = nn.Parameter(torch.empty(depth, hidden))
        self.head = nn.Linear(hidden, output_dim)

    def forward(self, x: torch.Tensor, dropout_masks=None) -> torch.Tensor:
        params = dict(self.named_parameters())
        return _head(params, _blocks(params, _embed(params, x)))


def pipe_mlp(hidden: int, depth: int, output_dim: int, input_shape,
             task: str = "classification") -> TorchModel:
    """The :class:`TorchModel` with its staged-execution record."""
    n_in = 1
    for d in input_shape:
        n_in *= int(d)
    with torch.device("meta"):
        module = PipeMLP(n_in, hidden, depth, output_dim)
    return TorchModel(module, tuple(input_shape), task=task,
                      pipeline=PipelineDef(
                          stage_leaves=("blocks_w", "blocks_b"),
                          hidden=hidden, embed=_embed, blocks=_blocks,
                          head=_head))


__all__ = ["PipeMLP", "pipe_mlp"]
