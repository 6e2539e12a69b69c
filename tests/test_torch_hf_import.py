"""HF Llama import into the port (``fedml_tpu_torch/llm/hf_import.py``)
against a random-init ``transformers.LlamaForCausalLM`` (no download) and
against the JAX package's ``hf_llama_state_dict_to_flax``, on the CPU.

Tolerances: logits 1e-4 relative to the largest HF logit (f32; HF's
rotate-half rotary against the port's interleaved pairs after the column
un-permutation, in another summation order), as ``tests/test_hf_import.py``
holds the JAX import; the converted tensors equal the flax ones exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from fedml_tpu.llm.hf_import import config_from_hf as j_config_from_hf  # noqa: E402
from fedml_tpu.llm.hf_import import hf_llama_state_dict_to_flax  # noqa: E402
from fedml_tpu_torch.llm.fedllm import lora_init  # noqa: E402
from fedml_tpu_torch.llm.hf_import import (config_from_hf,  # noqa: E402
                                           hf_llama_state_dict_to_torch,
                                           load_hf_llama)
from fedml_tpu_torch.llm.model import LlamaLM  # noqa: E402

TOKENS = np.array([[5, 17, 42, 99, 3, 250, 7, 1]])


def _tiny_hf(kv_heads=2, seed=0):
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=kv_heads,
        intermediate_size=128, max_position_embeddings=128,
        rms_norm_eps=1e-5, rope_theta=10000.0)
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(cfg).eval()


def _rel_err(out, ref):
    return np.max(np.abs(out - ref)) / max(np.max(np.abs(ref)), 1e-6)


@pytest.mark.parametrize("kv_heads", [4, 2])     # MHA and GQA
def test_logits_match_transformers(kv_heads):
    hf = _tiny_hf(kv_heads)
    cfg = dataclasses.replace(config_from_hf(hf.config), dtype=torch.float32)
    model = LlamaLM(cfg)
    model.load_state_dict(hf_llama_state_dict_to_torch(hf.state_dict(), cfg))
    with torch.no_grad():
        ref = hf(torch.tensor(TOKENS)).logits.numpy()
        out = model(torch.tensor(TOKENS)).numpy()
    assert _rel_err(out, ref) < 1e-4


@pytest.mark.parametrize("lora", [False, True])
def test_tensors_equal_the_flax_import(lora):
    hf = _tiny_hf(2, seed=1)
    sd = hf.state_dict()
    cfg = config_from_hf(hf.config)
    got = hf_llama_state_dict_to_torch(sd, cfg, lora=lora)
    ref = hf_llama_state_dict_to_flax(sd, j_config_from_hf(hf.config),
                                      lora=lora)
    flat = {"/".join(getattr(p, "key", str(p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert {k.replace(".", "/") for k in got} == set(flat)
    for k, t in got.items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), flat[k.replace(".", "/")])


def test_config_matches_the_jax_mapping():
    hf = _tiny_hf(2)
    got, ref = config_from_hf(hf.config), j_config_from_hf(hf.config)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if f.name == "dtype":
            assert str(b) == "torch.bfloat16" and np.dtype(a).name == "bfloat16"
        else:
            assert a == b, f.name


def test_load_hf_llama_with_adapters_keeps_the_forward():
    """``load_hf_llama`` on an in-memory model with ``lora_rank``: the base
    kernels land under ``w*.base``, and zero-B adapters reproduce the
    model without them (bf16, the import's type)."""
    hf = _tiny_hf(2, seed=2)
    plain, _ = load_hf_llama(hf, device="cpu")
    model, state = load_hf_llama(hf, lora_rank=4, device="cpu")
    assert "layer_0.attention.wq.base.kernel" in state
    assert model.layer_0.attention.wq.base.kernel.dtype == torch.bfloat16
    lora = lora_init(torch.Generator().manual_seed(0), model.lora_shapes(),
                     "cpu")
    with torch.no_grad():
        a = model(torch.tensor(TOKENS), lora)
        b = plain(torch.tensor(TOKENS))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
