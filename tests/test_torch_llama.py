"""The port's Llama (fedml_tpu_torch.llm.model) against the flax model on the
CPU, with the flax params and LoRA adapters carried across by
``llm/convert.py::from_flax``: logits, ``causal_nll`` and the LoRA
gradients of ``causal_nll``.

Tolerances (f32, TINY: GQA 4/2 heads, LoRA rank 4): logits atol 1e-5 and
the loss rtol 1e-6 — both packages run the same f32 operations and differ
only in summation order; gradients 1e-4 of each leaf's largest entry — the
backward passes also differ in their attention formulation (blockwise
autodiff in flax, the explicit flash backward in the port).  The bf16 case
is held loosely (logits 1e-1 abs on values of order 1) because the two
frameworks round bf16 intermediates at different points; it pins the
dtype promotions (RMSNorm output f32, f32 lm_head) rather than the digits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.llm import model as jmodel
from fedml_tpu_torch.llm import model as tmodel
from fedml_tpu_torch.llm.convert import from_flax, to_flax

RANK = 4


def _flax_setup(dtype=jnp.float32, seed=0):
    cfg = dataclasses.replace(jmodel.TINY, lora_rank=RANK, dtype=dtype)
    model = jmodel.LlamaLM(cfg)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  size=(2, 24))
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(tokens))
    rng = np.random.default_rng(seed + 1)
    lora = jax.tree_util.tree_map(
        lambda l: (0.05 * rng.standard_normal(l.shape)).astype(np.float32),
        variables["lora"])          # A and B both non-zero: real gradients
    targets = np.roll(tokens, -1, axis=1)
    return cfg, model, variables["params"], lora, tokens, targets


def _port(params, lora, dtype):
    cfg = dataclasses.replace(tmodel.TINY, lora_rank=RANK, dtype=dtype)
    return from_flax(jax.tree_util.tree_map(np.asarray, params), lora, cfg,
                     device="cpu")


def test_logits_loss_and_lora_grads_match_flax():
    cfg, model, params, lora, tokens, targets = _flax_setup()

    def loss_fn(lora):
        logits = model.apply({"params": params, "lora": lora},
                             jnp.asarray(tokens))
        return jmodel.causal_nll(logits, jnp.asarray(targets)), logits

    (j_loss, j_logits), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, lora))

    tm, tlora = _port(params, lora, torch.float32)
    tl = {k: v.requires_grad_(True) for k, v in tlora.items()}
    logits = tm(torch.as_tensor(tokens), tl)
    loss = tmodel.causal_nll(logits, torch.as_tensor(targets))
    grads = torch.autograd.grad(loss, list(tl.values()))

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
    _, g_np = to_flax(None, dict(zip(tl, grads)))
    for (path, ref), (_, got) in zip(
            jax.tree_util.tree_flatten_with_path(j_grads)[0],
            jax.tree_util.tree_flatten_with_path(g_np)[0]):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0, path
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("remat", ["full", "none"])
def test_remat_policies_agree(remat):
    """checkpointed and plain blocks give the same loss and gradients."""
    _, _, params, lora, tokens, targets = _flax_setup(seed=2)
    tm, tlora = _port(params, lora, torch.float32)
    tm.cfg = dataclasses.replace(tm.cfg, remat=remat)
    tl = {k: v.requires_grad_(True) for k, v in tlora.items()}
    loss = tmodel.causal_nll(tm(torch.as_tensor(tokens), tl),
                             torch.as_tensor(targets))
    grads = torch.autograd.grad(loss, list(tl.values()))
    tm.cfg = dataclasses.replace(tm.cfg, remat="none")
    tl2 = {k: v.detach().requires_grad_(True) for k, v in tlora.items()}
    loss2 = tmodel.causal_nll(tm(torch.as_tensor(tokens), tl2),
                              torch.as_tensor(targets))
    grads2 = torch.autograd.grad(loss2, list(tl2.values()))
    assert loss.item() == loss2.item()
    for a, b in zip(grads, grads2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bf16_promotions_match_flax():
    cfg, model, params, lora, tokens, _ = _flax_setup(dtype=jnp.bfloat16)
    j_logits = model.apply({"params": params, "lora": lora},
                           jnp.asarray(tokens))
    tm, tlora = _port(params, lora, torch.bfloat16)
    with torch.no_grad():
        logits = tm(torch.as_tensor(tokens), tlora)
        x = tm.tok_embed(torch.as_tensor(tokens))
        normed = tm.layer_0.attn_norm(x)
    assert j_logits.dtype == jnp.float32 and logits.dtype == torch.float32
    assert x.dtype == torch.bfloat16 and normed.dtype == torch.float32
    assert tm.layer_0.attention.wq.base.kernel.dtype == torch.bfloat16
    assert tm.layer_0.attn_norm.scale.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=1e-1)


def test_rope_interleaves_channel_pairs():
    """The rotation pairs channels (0,1), (2,3), ... as the flax model
    does, not HF's rotate_half halves."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 2, 6, 8)).astype(np.float32)
    pos = np.arange(6)
    ref = np.asarray(jmodel._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = tmodel._rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_to_flax_round_trips_params():
    _, _, params, lora, _, _ = _flax_setup(seed=3)
    tm, tlora = _port(params, lora, torch.float32)
    p_np, l_np = to_flax(tm, tlora)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(p_np)[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(jax.tree_util.tree_leaves(lora),
                    jax.tree_util.tree_leaves(l_np)):
        np.testing.assert_array_equal(a, b)


def test_from_flax_builds_on_the_card_unless_asked(monkeypatch):
    """Like every entry point of the port, ``from_flax`` puts a model it
    builds on the card by default; the CPU only when the caller asks."""
    _, _, params, lora, _, _ = _flax_setup(seed=5)
    moved = []
    real_to = tmodel.LlamaLM.to

    def record_to(self, *args, **kwargs):
        moved.append(str(args[0] if args else kwargs.get("device")))
        return real_to(self, "cpu")

    monkeypatch.setattr(tmodel.LlamaLM, "to", record_to)
    cfg = dataclasses.replace(tmodel.TINY, lora_rank=RANK)
    from_flax(jax.tree_util.tree_map(np.asarray, params), lora, cfg)
    from_flax(jax.tree_util.tree_map(np.asarray, params), lora, cfg,
              device="cpu")
    assert moved == ["cuda", "cpu"]
