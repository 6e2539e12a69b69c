"""Weight carry-over between the JAX package's flax trees and the port.

Threefry draws cannot be reproduced in PyTorch, so parity runs start both
packages from the same weights: :func:`from_flax` loads the JAX package's
``params`` and ``lora`` trees (nested dicts of numpy arrays, e.g.
``layer_0/attention/wq/base/kernel`` of shape ``(in, out)``,
``layer_0/attention/wq/A``, ``attn_norm/scale``, ``tok_embed/embedding``,
``lm_head/kernel``) into a :class:`~fedml_tpu_torch.llm.model.LlamaLM`
and a flat adapter dict; :func:`to_flax` is the inverse.  The port keeps the
flax names and layouts, so the mapping is the path with ``.`` for ``/``.

For serving, :func:`lora_from_flax` reads one adapter tree (a bank row of
the JAX registry) into the flat dict the port's bank takes,
:func:`quantized_from_flax` an int8 weight-only tree of
``fedml_tpu.llm.quantization`` into the port's
:class:`~fedml_tpu_torch.llm.quantization.QuantizedParams`, and
:func:`cache_from_flax` / :func:`cache_to_flax` carry a flax ``cache``
collection (``layer_{i}/attention/{k,v,k_scale,v_scale}``) to and from the
port's :class:`~fedml_tpu_torch.llm.model.KVCache`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.tree import flatten, unflatten
from .model import KVCache, LlamaConfig, LlamaLM
from .quantization import Q8, QuantizedParams


def from_flax(params_np: Mapping, lora_np: Optional[Mapping],
              cfg: LlamaConfig, device="cuda",
              model: Optional[LlamaLM] = None, mesh=None
              ) -> Tuple[LlamaLM, Dict[str, torch.Tensor]]:
    """Load flax ``params``/``lora`` trees into ``model`` (a new
    ``LlamaLM(cfg)`` on ``device`` if none is given; with ``mesh`` this
    rank's tensor-parallel ``LlamaLM(cfg, mesh=mesh)``, built on the meta
    device).  A tensor-parallel model takes only its slice of each leaf
    (``LlamaLM.tp_dims``), so no whole weight reaches the device.  Returns
    the model and the flat f32 adapter dict (whole on every rank).  Every
    parameter must be present with its exact (whole) shape."""
    if model is None:
        if mesh is None:
            model = LlamaLM(cfg).to(device)
        else:
            with torch.device("meta"):
                model = LlamaLM(cfg, mesh=mesh)
            model = model.to_empty(device=device)
    flat = flatten(params_np)
    dims = model.tp_dims()
    full = model.full_shapes()
    seen = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            key = name.replace(".", "/")
            arr = np.asarray(flat[key])
            if tuple(arr.shape) != tuple(full[name]):
                raise ValueError(f"{key}: flax shape {arr.shape} vs port "
                                 f"{tuple(full[name])}")
            if name in dims:
                d, n = dims[name], p.shape[dims[name]]
                arr = np.take(arr, np.arange(model.tp.rank * n,
                                             (model.tp.rank + 1) * n),
                              axis=d)
            p.copy_(torch.tensor(np.asarray(arr, np.float32)).to(p.dtype))
            seen.add(key)
    extra = set(flat) - seen
    if extra:
        raise ValueError(f"flax params not in the port's model: "
                         f"{sorted(extra)[:5]}")
    lora = {}
    if lora_np:
        dev = next(model.parameters()).device
        shapes = model.lora_shapes()
        for key, arr in flatten(lora_np).items():
            if tuple(np.shape(arr)) != shapes.get(key):
                raise ValueError(f"lora {key}: shape {np.shape(arr)} vs "
                                 f"{shapes.get(key)}")
            lora[key] = torch.tensor(np.asarray(arr, np.float32), device=dev)
    return model, lora


def to_flax(model: Optional[LlamaLM], lora: Optional[Mapping] = None):
    """Inverse of :func:`from_flax`: ``(params_np, lora_np)`` nested dicts
    of f32 numpy arrays (``None`` for an argument that is ``None``)."""
    params = None
    if model is not None:
        params = unflatten({
            n.replace(".", "/"): p.detach().float().cpu().numpy()
            for n, p in model.named_parameters()})
    lora_np = None
    if lora is not None:
        lora_np = unflatten({k: v.detach().float().cpu().numpy()
                             for k, v in lora.items()})
    return params, lora_np


def lora_from_flax(lora_np: Mapping, device="cuda") -> Dict[str, torch.Tensor]:
    """One flax adapter tree (``{"layer_0": {"attention": {"wq": {"A":
    ...}}}}``) as the port's flat f32 adapter dict."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in flatten(lora_np).items()}


def quantized_from_flax(qtree_np: Mapping, device="cuda",
                        dtype=torch.float32) -> QuantizedParams:
    """A JAX int8 weight-only tree (nested dicts of numpy arrays whose
    quantized leaves are ``{"__q8__": 1, "q": int8, "scale": f32}``) as the
    port's quantized dict: codes and scales carried bitwise, every other
    leaf as ``dtype`` (the flax path with ``.`` for ``/``)."""
    out = QuantizedParams()

    def walk(node, path):
        if isinstance(node, Mapping) and "__q8__" in node:
            out[path + Q8 + ".q"] = torch.from_numpy(
                np.array(node["q"], np.int8)).to(device)
            out[path + Q8 + ".scale"] = torch.from_numpy(
                np.array(node["scale"], np.float32)).to(device)
        elif isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else str(k))
        else:
            out[path] = torch.tensor(np.asarray(node, np.float32),
                                     dtype=dtype, device=device)

    walk(qtree_np, "")
    out.check()
    return out


_CACHE_NAMES = ("k", "v", "k_scale", "v_scale")


def cache_from_flax(cache_np: Mapping, device="cuda") -> KVCache:
    """A flax ``cache`` collection (numpy leaves, int8 kept int8) as a
    :class:`KVCache` on ``device``; bf16 leaves may arrive as f32 and are
    kept in the dtype they come in."""
    flat = flatten(cache_np)
    n = 1 + max(int(k.split("/")[0][len("layer_"):]) for k in flat)
    layers = []
    for i in range(n):
        lay = {}
        for name in _CACHE_NAMES:
            key = f"layer_{i}/attention/{name}"
            if key in flat:
                lay[name] = torch.from_numpy(
                    np.array(flat[key])).to(device)
        layers.append(lay)
    return KVCache(layers)


def cache_to_flax(cache: KVCache):
    """Inverse of :func:`cache_from_flax`: nested dicts of numpy arrays
    (float leaves as f32)."""
    out = {}
    for i, lay in enumerate(cache.layers):
        for name, t in lay.items():
            t = t.detach().cpu()
            out[f"layer_{i}/attention/{name}"] = (
                t.numpy() if t.dtype == torch.int8 else t.float().numpy())
    return unflatten(out)
