"""Model record: an ``nn.Module`` + the metadata the trainers need (port of
``fedml_tpu.models.base.FlaxModel``).

Parameters live outside the module, as a ``{name: tensor}`` dict keyed by
the module's own parameter names (the flax names kept: ``Conv_0.weight``,
``Dense_1.bias``, ...), so one round can hold a different copy per client
and run them through :func:`torch.func.functional_call` and ``vmap``.  The
module itself is built on the ``meta`` device: it only describes shapes and
the forward.

Dropout takes its keep-masks as an input (:meth:`TorchModel.dropout_masks`
draws them from an explicit generator), because random draws inside
``torch.func.vmap`` take no generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

TensorDict = Dict[str, torch.Tensor]

# flax's truncated-normal correction: the std of N(0, 1) cut at ±2
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, fan_in: int, generator: torch.Generator
                 ) -> torch.Tensor:
    """flax's default kernel initialiser, ``variance_scaling(1, "fan_in",
    "truncated_normal")``: N(0, 1) cut at ±2 (inverse-CDF draw), scaled to
    std ``sqrt(1/fan_in)``."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(shape, generator=generator, device=generator.device)
    z = math.sqrt(2) * torch.erfinv(lo + (hi - lo) * u)
    z = torch.clamp(z, -2.0, 2.0)
    return z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def apply_dropout(x: torch.Tensor, keep: Optional[torch.Tensor],
                  rate: float) -> torch.Tensor:
    """flax ``nn.Dropout``: kept entries scaled by 1/(1-rate), the rest 0;
    ``keep`` None is the deterministic (eval) mode."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0)


@dataclasses.dataclass
class TorchModel:
    module: nn.Module
    #: shape of ONE example (no batch dim), in the dataset's HWC layout
    input_shape: Tuple[int, ...]
    #: drives the loss and metric: "classification"
    task: str = "classification"
    #: whether a train-mode apply takes dropout keep-masks
    has_dropout: bool = False

    def init(self, generator: torch.Generator) -> TensorDict:
        """flax's default initialisers: ``lecun_normal`` kernels and zero
        biases, drawn in parameter order from ``generator`` on its
        device."""
        params = {}
        for name, p in self.module.named_parameters():
            if name.endswith("bias"):
                params[name] = torch.zeros(p.shape, device=generator.device)
            else:
                fan_in = math.prod(p.shape[1:])   # (out, in[, kh, kw])
                params[name] = lecun_normal(p.shape, fan_in, generator)
        return params

    def dropout_sites(self) -> Sequence[Tuple[Tuple[int, ...], float]]:
        """(per-example shape, rate) of each dropout the train forward
        applies, in order."""
        sites = getattr(self.module, "dropout_sites", None)
        return sites(self.input_shape) if sites is not None else ()

    def dropout_masks(self, generator: torch.Generator,
                      lead: Tuple[int, ...]) -> Tuple[torch.Tensor, ...]:
        """Keep-masks for every dropout site, shaped ``lead + site shape``
        (e.g. ``(clients, steps, batch)``), drawn on the generator's
        device: ``uniform < 1 - rate`` as flax's Bernoulli draw."""
        return tuple(
            torch.rand(tuple(lead) + tuple(shape), generator=generator,
                       device=generator.device) < (1.0 - rate)
            for shape, rate in self.dropout_sites())

    def apply(self, params: TensorDict, x: torch.Tensor, train: bool = False,
              dropout_masks: Optional[Tuple[torch.Tensor, ...]] = None
              ) -> torch.Tensor:
        masks = dropout_masks if (self.has_dropout and train) else None
        return torch.func.functional_call(self.module, params, (x, masks))
