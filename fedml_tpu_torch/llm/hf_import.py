"""HuggingFace Llama checkpoint import (port of ``fedml_tpu.llm.hf_import``):
a ``transformers`` ``LlamaForCausalLM`` state dict mapped onto the port's
:class:`~fedml_tpu_torch.llm.model.LlamaLM`.

======================================================  =======================
``model.embed_tokens.weight``                           ``tok_embed.embedding``
``model.layers.{i}.self_attn.{q,k,v,o}_proj.weight``    ``layer_{i}.attention.w{q,k,v,o}[.base].kernel`` (transposed)
``model.layers.{i}.mlp.{gate,up,down}_proj.weight``     ``layer_{i}.mlp.w_{gate,up,down}.kernel`` (transposed)
``model.layers.{i}.input_layernorm.weight``             ``layer_{i}.attn_norm.scale``
``model.layers.{i}.post_attention_layernorm.weight``    ``layer_{i}.mlp_norm.scale``
``model.norm.weight``                                   ``final_norm.scale``
``lm_head.weight``                                      ``lm_head.kernel`` (transposed)
======================================================  =======================

HF stores the q/k projections permuted for its rotate-half rotary layout;
this model rotates interleaved channel pairs, so the q/k output columns are
un-permuted per head.  ``transformers`` is imported only to read a
checkpoint path; nothing else here needs it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .model import LlamaConfig, LlamaLM


def _state_dict_to_tree(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """A torch ``state_dict`` as a nested dict of numpy arrays, keys split
    on '.': a 2-D ``weight`` becomes its transposed ``kernel`` ``(in,
    out)``, a 1-D ``weight`` a norm ``scale``."""
    out: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        arr = np.asarray(tensor.detach().float().cpu().numpy()
                         if hasattr(tensor, "detach") else tensor)
        *parts, leaf = key.split(".")
        if leaf == "weight":
            if arr.ndim == 2:
                arr, leaf = arr.T, "kernel"
            else:
                leaf = "scale"
        node = out
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return out


def _unpermute_rope_cols(kernel: np.ndarray, n_heads: int) -> np.ndarray:
    """Invert HF's per-head permutation on an ``(in, out)`` q/k kernel: HF
    groups each head's output columns as ``(2, head_dim/2)`` (rotate-half
    halves); the interleaved-pair rotation wants ``(head_dim/2, 2)``."""
    in_dim, out_dim = kernel.shape
    head_dim = out_dim // n_heads
    k = kernel.reshape(in_dim, n_heads, 2, head_dim // 2)
    return k.transpose(0, 1, 3, 2).reshape(in_dim, out_dim)


def config_from_hf(hf_config) -> LlamaConfig:
    """Map a ``transformers.LlamaConfig`` to :class:`LlamaConfig` (bf16)."""
    return LlamaConfig(
        vocab_size=int(hf_config.vocab_size),
        dim=int(hf_config.hidden_size),
        n_layers=int(hf_config.num_hidden_layers),
        n_heads=int(hf_config.num_attention_heads),
        n_kv_heads=int(getattr(hf_config, "num_key_value_heads", None)
                       or hf_config.num_attention_heads),
        ffn_dim=int(hf_config.intermediate_size),
        max_seq_len=int(getattr(hf_config, "max_position_embeddings", 4096)),
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        norm_eps=float(getattr(hf_config, "rms_norm_eps", 1e-5)),
        dtype=torch.bfloat16,
    )


def hf_llama_state_dict_to_torch(state_dict: Dict[str, Any],
                                 cfg: LlamaConfig, lora: bool = False
                                 ) -> Dict[str, torch.Tensor]:
    """HF ``LlamaForCausalLM.state_dict()`` → ``{port parameter name: f32
    tensor}`` (load it with ``LlamaLM.load_state_dict``).  ``lora=True``
    targets the adapter layout (``wq.base.kernel``)."""
    g = _state_dict_to_tree(state_dict)
    model = g["model"]
    base = ".base" if lora else ""
    flat = {
        "tok_embed.embedding": model["embed_tokens"]["kernel"].T,
        "final_norm.scale": model["norm"]["scale"],
        "lm_head.kernel": g["lm_head"]["kernel"],
    }
    for i in range(cfg.n_layers):
        li = model["layers"][str(i)]
        sa, mlp = li["self_attn"], li["mlp"]
        pre = f"layer_{i}"
        flat.update({
            f"{pre}.attention.wq{base}.kernel": _unpermute_rope_cols(
                sa["q_proj"]["kernel"], cfg.n_heads),
            f"{pre}.attention.wk{base}.kernel": _unpermute_rope_cols(
                sa["k_proj"]["kernel"], cfg.n_kv_heads),
            f"{pre}.attention.wv{base}.kernel": sa["v_proj"]["kernel"],
            f"{pre}.attention.wo{base}.kernel": sa["o_proj"]["kernel"],
            f"{pre}.attn_norm.scale": li["input_layernorm"]["scale"],
            f"{pre}.mlp_norm.scale": li["post_attention_layernorm"]["scale"],
            f"{pre}.mlp.w_gate.kernel": mlp["gate_proj"]["kernel"],
            f"{pre}.mlp.w_up.kernel": mlp["up_proj"]["kernel"],
            f"{pre}.mlp.w_down.kernel": mlp["down_proj"]["kernel"],
        })
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in flat.items()}


def load_hf_llama(model_or_path, lora_rank: int = 0, device="cuda"):
    """An in-memory ``transformers`` Llama model (or a local checkpoint
    directory) → ``(LlamaLM on device, state dict)``."""
    if isinstance(model_or_path, str):
        from transformers import LlamaForCausalLM
        model_or_path = LlamaForCausalLM.from_pretrained(model_or_path)
    cfg = config_from_hf(model_or_path.config)
    if lora_rank:
        cfg = dataclasses.replace(cfg, lora_rank=lora_rank)
    state = hf_llama_state_dict_to_torch(model_or_path.state_dict(), cfg,
                                         lora=lora_rank > 0)
    with torch.device(device):
        model = LlamaLM(cfg)
    model.load_state_dict(state)
    return model, state


__all__ = ["config_from_hf", "hf_llama_state_dict_to_torch",
           "load_hf_llama"]
