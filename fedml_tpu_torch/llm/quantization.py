"""Weight-only int8 quantization for serving (port of
``fedml_tpu.llm.quantization``).

Decode re-reads every weight for each generated token, so storing the
matrix weights as int8 codes with one f32 scale per row of the kernel
halves the bytes a bf16 tree holds (a quarter of an f32 one).

The quantized tree is the port's own flat dict, a :class:`QuantizedParams`:
every eligible weight ``name`` (a ``named_parameters()`` name) is replaced
by two entries, ``name + ".__q8__.q"`` (int8 codes, the weight's shape) and
``name + ".__q8__.scale"`` (f32, the weight's shape with the channel axis
reduced to 1); every other leaf stays under its name in full precision.
Eligible: floating leaves with ``ndim >= 2`` and at least ``min_size``
elements (the kernels ``(in, out)``, the embedding ``(vocab, dim)``, the
experts); norm scales and small leaves stay as they are.  The codes and
scales are bitwise the JAX function's on the same weights: f32 arithmetic,
``scale = max(amax, 1e-12) / 127``, round half to even, clip to ±127.

Usage::

    qparams, stats = quantize_params_int8(model)   # or a {name: tensor} dict
    logits = make_quantized_apply(model)(qparams, tokens)

The serving paths (``generate``, the batching engines, the server) take a
:class:`QuantizedParams` wherever they take a weight dict.  The dequantize
is never done for the whole tree: each weight is dequantized at the product
that consumes it, ``(q.float() * scale).to(dtype)`` as JAX computes
``(q f32 * scale).astype(dtype)``, so the transient is at most one matrix
(an embedding lookup gathers its code rows first).  ``dtype`` is the
model's compute type (:func:`weight_dtype`).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch
import torch.nn.functional as F

#: the marker of a quantized weight's two entries
Q8 = ".__q8__"
_Q, _SCALE = Q8 + ".q", Q8 + ".scale"


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor, dtype
                      ) -> torch.Tensor:
    """``(q f32 * scale)`` rounded once to ``dtype``: one pass, the product
    computed in f32 and cast on the store."""
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    return torch.mul(q, scale, out=out)


class _Int8Weight(torch.Tensor):
    """A weight held as int8 codes and f32 scales that dequantizes to
    ``wdtype`` wherever an operation reads it (``F.embedding`` gathers the
    code rows first).  Attribute reads (shape, device, ...) see the codes.
    Made by :meth:`QuantizedParams.lazy` for ``functional_call``."""

    @staticmethod
    def __new__(cls, q, scale, wdtype):
        t = torch.Tensor._make_subclass(cls, q, False)
        t.q, t.scale, t.wdtype = q, scale, wdtype
        return t

    def dequantize(self) -> torch.Tensor:
        return dequantize_weight(self.q, self.scale, self.wdtype)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.embedding and isinstance(args[1], cls):
            w = args[1]
            rows = F.embedding(args[0], w.q)
            scale = F.embedding(args[0], w.scale)
            return dequantize_weight(rows, scale, w.wdtype)
        if getattr(func, "__name__", None) == "__get__":
            return func(*(a.q if isinstance(a, cls) else a for a in args))
        unwrap = lambda a: a.dequantize() if isinstance(a, cls) else a
        return func(*(unwrap(a) for a in args),
                    **{k: unwrap(v) for k, v in kwargs.items()})


class QuantizedParams(dict):
    """A quantized weight tree (module docstring); a plain flat dict of
    tensors, told apart from a float dict by its type."""

    def pairs(self) -> Dict[str, tuple]:
        """``{name: (codes, scale)}`` of the quantized weights."""
        return {k[:-len(_Q)]: (v, self[k[:-len(_Q)] + _SCALE])
                for k, v in self.items() if k.endswith(_Q)}

    def plain(self) -> Dict[str, torch.Tensor]:
        """The leaves kept in full precision."""
        return {k: v for k, v in self.items() if Q8 not in k}

    def lazy(self, dtype) -> Dict[str, torch.Tensor]:
        """The ``{name: tensor}`` dict ``functional_call`` takes, each
        quantized weight a view that dequantizes to ``dtype`` at its
        consuming product.  Built once per dtype (the tree is not to be
        mutated after it is used)."""
        cache = self.__dict__.setdefault("_lazy", {})
        if dtype not in cache:
            out = self.plain()
            for name, (q, s) in self.pairs().items():
                out[name] = _Int8Weight(q, s, dtype)
            cache[dtype] = out
        return cache[dtype]

    def check(self) -> None:
        """Every quantized weight has int8 codes and an f32 scale of the
        codes' rank; every other leaf is a floating tensor."""
        for k, v in self.items():
            if k.endswith(_Q):
                s = self.get(k[:-len(_Q)] + _SCALE)
                if v.dtype != torch.int8 or s is None \
                        or s.dtype != torch.float32 or s.dim() != v.dim():
                    raise ValueError(f"{k}: int8 codes need an f32 scale of "
                                     "the same rank")
            elif k.endswith(_SCALE):
                if k[:-len(_SCALE)] + _Q not in self:
                    raise ValueError(f"{k}: a scale without codes")
            elif not (isinstance(v, torch.Tensor) and v.is_floating_point()):
                raise ValueError(f"{k}: not a floating tensor")


def _named(params) -> Mapping[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


@torch.no_grad()
def quantize_params_int8(params, min_size: int = 1024,
                         channel_axis: int = -1):
    """Per-channel symmetric int8 quantization of every floating leaf with
    ``ndim >= 2`` and at least ``min_size`` elements of ``params`` (a
    ``{name: tensor}`` dict, or a module's ``named_parameters()``),
    computed on the leaves' device.  Returns ``(qtree, stats)``, ``stats``
    the byte counts before and after."""
    dense = qbytes = 0
    out = QuantizedParams()
    for name, x in _named(params).items():
        x = x.detach()
        nbytes = x.numel() * x.element_size()
        dense += nbytes
        if x.dim() < 2 or x.numel() < min_size or not x.is_floating_point():
            out[name] = x
            qbytes += nbytes
            continue
        xf = x.float()
        amax = xf.abs().amax(dim=channel_axis, keepdim=True)
        scale = amax.clamp_min(1e-12) / 127.0
        q = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
        del xf
        out[name + _Q] = q
        out[name + _SCALE] = scale
        qbytes += q.numel() + scale.numel() * 4
    return out, {"dense_bytes": dense, "quantized_bytes": qbytes,
                 "ratio": qbytes / max(dense, 1)}


def dequantize_params(qtree: QuantizedParams, dtype=torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """The whole tree dequantized to ``dtype`` (a copy of every weight:
    tests and diagnostics; the serving paths dequantize per product)."""
    out = qtree.plain()
    for name, (q, s) in qtree.pairs().items():
        out[name] = dequantize_weight(q, s, dtype)
    return out


def weight_dtype(model):
    """The compute type a model's weights dequantize to: its configured
    ``dtype``, else f32."""
    return getattr(getattr(model, "cfg", None), "dtype", None) or \
        torch.float32


def make_quantized_apply(model, dtype=None) -> Callable:
    """``apply_fn(qparams, tokens, *args, **kw)``: the model's forward with
    each quantized weight dequantized at its consuming product."""
    if dtype is None:
        dtype = weight_dtype(model)

    def apply_fn(qparams, tokens, *args, **kw):
        return torch.func.functional_call(model, qparams.lazy(dtype),
                                          (tokens,) + args, kw)

    return apply_fn


@torch.no_grad()
def quantization_error(params, qtree: QuantizedParams) -> Dict[str, float]:
    """Max and mean over leaves of each leaf's max reconstruction error
    relative to its max magnitude (diagnostics; f32 on the leaves'
    device)."""
    pairs = qtree.pairs()
    errs = []
    for name, o in _named(params).items():
        o = o.detach().float()
        if name in pairs:
            q, s = pairs[name]
            r = q.float() * s
        else:
            r = qtree[name].float()
        denom = o.abs().max().clamp_min(1e-12)
        errs.append(float((o - r).abs().max() / denom))
    return {"max_rel_err": max(errs), "mean_rel_err": sum(errs) / len(errs)}


__all__ = ["Q8", "QuantizedParams", "dequantize_params", "dequantize_weight",
           "make_quantized_apply", "quantization_error",
           "quantize_params_int8", "weight_dtype"]
