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
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

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


#: flax's leaf name of each (module type, parameter) the port's models use
_FLAX_LEAF = {
    (nn.Linear, "weight"): ("dense", "kernel"),
    (nn.Conv2d, "weight"): ("conv", "kernel"),
    (nn.ConvTranspose2d, "weight"): ("conv_transpose", "kernel"),
    (nn.Embedding, "weight"): ("embedding", "embedding"),
    (nn.LayerNorm, "weight"): ("scale", "scale"),
    (nn.GroupNorm, "weight"): ("scale", "scale"),
}


def param_kinds(module: nn.Module) -> Dict[str, Tuple[str, str, nn.Module]]:
    """``{port name: (kind, flax path, owning module)}`` for every
    parameter, in parameter order.  ``kind`` is "dense", "conv",
    "conv_transpose", "embedding", "scale", "bias", "kernel" (a kernel in
    flax's own layout, listed in its module's ``flax_kinds``: the causal
    LM's ``(in, out)`` and ``(E, in, out)``) or "param" (a bare
    ``nn.Parameter``, kept
    by its own name); the flax path joins the module path with flax's leaf
    name (``layer_0.wq.weight`` → ``layer_0/wq/kernel``,
    ``tok_embed.weight`` → ``tok_embed/embedding``, ``pos_embed`` →
    ``pos_embed``)."""
    out = {}
    for name, _ in module.named_parameters():
        path, _, leaf = name.rpartition(".")
        owner = module.get_submodule(path)
        kind, flax_leaf = "param", leaf
        own = getattr(owner, "flax_kinds", {})
        if leaf in own:
            # a module that keeps flax's own layout names its leaves' kinds
            kind = own[leaf]
        elif leaf == "bias":
            kind = "bias"
        else:
            for (mtype, pname), (k, fl) in _FLAX_LEAF.items():
                if isinstance(owner, mtype) and leaf == pname:
                    kind, flax_leaf = k, fl
                    break
        out[name] = (kind, "/".join(_flax_path(module, path) + [flax_leaf])
                     if path else flax_leaf, owner)
    return out


def _flax_path(module: nn.Module, path: str):
    """flax's module names along ``path``: a module whose children cannot
    carry flax's name as a Python attribute (the LSTM cell's ``if``) maps
    them in ``flax_names``."""
    names = []
    for part in path.split("."):
        names.append(getattr(module, "flax_names", {}).get(part, part))
        module = module.get_submodule(part)
    return names


def orthogonal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax's ``initializers.orthogonal()`` for a square kernel: Q of the QR
    of a normal draw, its columns' signs fixed by R's diagonal (a draw from
    the Haar measure)."""
    q, r = torch.linalg.qr(torch.randn(shape, generator=generator,
                                       device=generator.device))
    return q * torch.sign(torch.diagonal(r))


@dataclasses.dataclass
class PipelineDef:
    """Layer-indexed stage assignment of a staged model (port of
    ``fedml_tpu.models.base.PipelineDef``).  The named ``stage_leaves``
    are parameters stacked on a leading layer axis (dim 0), which the
    pipeline layout splits over ``stage`` in contiguous chunks (and, for
    ndim >= 3, dim 1 over ``model``, row-parallel).  The three functions
    are the model's forward split at the stage boundaries, over a
    ``{name: tensor}`` dict holding this rank's shards of the staged
    leaves and the others whole."""

    #: parameter names stacked ``(depth, ...)`` on dim 0
    stage_leaves: Tuple[str, ...]
    #: activation width crossing stage boundaries
    hidden: int
    #: ``(params, x) -> h``: the stage-0 input transform
    embed: Callable[[Any, Any], Any]
    #: ``(params, h, mesh) -> h``: this rank's layer chunk in order,
    #: row-parallel over ``mesh``'s model group (plain with ``None``)
    blocks: Callable[..., Any]
    #: ``(params, h) -> logits``: the last stage's output head
    head: Callable[[Any, Any], Any]


@dataclasses.dataclass
class TorchModel:
    module: nn.Module
    #: shape of ONE example (no batch dim), in the dataset's HWC layout
    input_shape: Tuple[int, ...]
    #: drives the loss and metric: "classification", "lm" (cross-entropy
    #: over every position), "tag_prediction" (BCE over multi-hot tags) or
    #: "segmentation" (per-pixel cross-entropy, FedSeg's own loop)
    task: str = "classification"
    #: whether a train-mode apply takes dropout keep-masks
    has_dropout: bool = False
    #: dtype of the inputs (int32 token ids for the text and LSTM models)
    input_dtype: torch.dtype = torch.float32
    #: staged-execution record of a model the 3-D ``client × stage ×
    #: model`` pipeline layout can run (``simulation/mesh/pipeline.py``)
    pipeline: Optional[PipelineDef] = None

    def init(self, generator: torch.Generator) -> TensorDict:
        """flax's default initialisers, per parameter (:func:`param_kinds`):
        ``lecun_normal`` Dense and Conv kernels (``orthogonal`` where the
        owning layer sets ``kernel_init``: the LSTM's hidden kernels), zero
        biases, unit norm
        scales, ``nn.Embed``'s plain normal of std 1/√features, and a bare
        parameter's normal of the std its module declares
        (``normal_init_std``), drawn in parameter order from ``generator``
        on its device."""
        params = {}
        dev = generator.device
        for name, (kind, _, owner) in param_kinds(self.module).items():
            shape = self.module.get_parameter(name).shape
            if kind == "bias":
                params[name] = torch.zeros(shape, device=dev)
            elif kind == "scale":
                params[name] = torch.ones(shape, device=dev)
            elif kind == "embedding":
                params[name] = torch.randn(shape, generator=generator,
                                           device=dev) / math.sqrt(shape[-1])
            elif kind == "param":
                std = owner.normal_init_std[name.rsplit(".", 1)[-1]]
                params[name] = std * torch.randn(shape, generator=generator,
                                                 device=dev)
            elif kind == "kernel":   # flax layout: fan_in is all but the
                params[name] = lecun_normal(      # output axis
                    shape, math.prod(shape[:-1]), generator)
            elif getattr(owner, "kernel_init", None) == "orthogonal":
                params[name] = orthogonal(shape, generator)
            elif kind == "conv_transpose":   # (in, out, kh, kw)
                params[name] = lecun_normal(
                    shape, shape[0] * math.prod(shape[2:]), generator)
            else:   # dense/conv kernel: (out, in[, kh, kw])
                params[name] = lecun_normal(shape, math.prod(shape[1:]),
                                            generator)
        return params

    def flat_layout(self) -> Tuple[Tuple[str, str], ...]:
        """``(name, kind)`` of every parameter in the JAX package's flat
        order (its flax path's ``tree_flatten`` order: nested keys sorted),
        for :class:`~fedml_tpu_torch.core.flatmodel.FlatSpec`."""
        kinds = param_kinds(self.module)
        order = sorted(kinds, key=lambda n: tuple(kinds[n][1].split("/")))
        return tuple((n, kinds[n][0]) for n in order)

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
