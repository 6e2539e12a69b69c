"""The port's MoEMLP (``fedml_tpu_torch/llm/moe.py``) against the flax
``fedml_tpu.llm.moe.MoEMLP`` on the CPU, the flax params carried across,
on numpy-seeded inputs: outputs and the load-balancing value with a
capacity that drops nothing and one that drops tokens; against the plain
per-token version (a torch copy of ``tests/test_moe.py``'s reference); the
LM with MoE blocks against the flax LM; and under ``torch.func.vmap``.

Tolerances (f32): outputs 1e-5 abs (the same f32 products in another
order), aux 1e-6; the LM's logits 1e-5 and its LoRA gradients 1e-4 of
each leaf's largest entry (as ``tests/test_torch_llama.py``); bf16 2e-2 of
the largest entry (bf16 rounds the expert products at different points).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.llm import model as jmodel
from fedml_tpu.llm.moe import MoEMLP as JMoE
from fedml_tpu_torch.llm import model as tmodel
from fedml_tpu_torch.llm.convert import from_flax, to_flax
from fedml_tpu_torch.llm.moe import MoEMLP, moe_per_token

B, S, DIM, FFN, E, K = 2, 8, 16, 32, 4, 2


def _pair(capacity_factor, dtype=jnp.float32, seed=0):
    jm = JMoE(dim=DIM, ffn_dim=FFN, n_experts=E, top_k=K,
              capacity_factor=capacity_factor, dtype=dtype)
    x = np.random.default_rng(seed).standard_normal((B, S, DIM)).astype(
        np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed + 1), jnp.asarray(x))
        ["params"])
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tm = MoEMLP(DIM, FFN, E, K, capacity_factor, dtype=tdtype)
    with torch.no_grad():
        tm.router.kernel.copy_(torch.tensor(params["router"]["kernel"]))
        for name in ("w_gate", "w_up", "w_down"):
            getattr(tm, name).copy_(torch.tensor(params[name]))
    return jm, params, tm, x


@pytest.mark.parametrize("capacity_factor", [10.0, 0.5])
def test_moe_matches_flax(capacity_factor):
    jm, params, tm, x = _pair(capacity_factor)
    j_out, state = jm.apply({"params": params}, jnp.asarray(x),
                            mutable=["losses"])
    out, aux = tm.forward_with_aux(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-5)
    j_aux = float(np.asarray(state["losses"]["moe_aux"]).reshape(-1)[0])
    assert abs(aux.item() - j_aux) < 1e-6, (aux.item(), j_aux)
    plain = moe_per_token(tm, torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-5)
    if capacity_factor < 1:
        # cap = int(0.5·2·16/4) = 4 slots an expert for 32 choices: some
        # expert is chosen more often than it has slots
        xt = torch.tensor(x).reshape(-1, DIM)
        idx = torch.topk(torch.softmax(xt @ tm.router.kernel, -1), K).indices
        assert torch.bincount(idx.flatten(), minlength=E).max() > 4


def test_moe_bf16_matches_flax():
    jm, params, tm, x = _pair(1.25, jnp.bfloat16, seed=2)
    j_out, _ = jm.apply({"params": params}, jnp.asarray(x),
                        mutable=["losses"])
    out = tm(torch.tensor(x))
    ref = np.asarray(j_out, np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref,
                               atol=2e-2 * np.abs(ref).max())


def test_moe_capacity_truncates_like_python_int():
    """cap = max(1, int(cf·k·N/E)) at N = 16, k 2, E 4: 1.25 → 10,
    0.3 → int(2.4) = 2, 0.1 → max(1, 0) = 1."""
    for cf, want in ((1.25, 10), (0.3, 2), (0.1, 1)):
        assert MoEMLP(DIM, FFN, E, K, cf).capacity(B * S) == want


def test_moe_runs_under_vmap_as_a_loop():
    _, _, tm, _ = _pair(1.25, seed=3)
    xs = torch.tensor(np.random.default_rng(5).standard_normal(
        (3, B, S, DIM)).astype(np.float32))
    got = torch.func.vmap(tm)(xs)
    want = torch.stack([tm(x) for x in xs])
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_moe_refuses_a_mesh_by_name():
    """Expert parallelism runs over a model group that divides the experts
    (``tests/test_torch_tp.py``); another model factor raises by name."""
    from fedml_tpu_torch.core.mesh import Mesh
    with pytest.raises(NotImplementedError, match="mesh"):
        MoEMLP(DIM, FFN, E, K, mesh=Mesh(3, 0, "cpu", model=3))
    assert MoEMLP(DIM, FFN, E, K, mesh=Mesh(2, 1, "cpu", model=2)
                  ).w_gate.shape[0] == E // 2


def test_llama_with_moe_blocks_matches_flax():
    """TINY with 4 experts top-2 and LoRA rank 4: logits, loss and the
    adapters' gradients from the same weights; the MoE leaves carried by
    ``from_flax`` and back by ``to_flax``."""
    cfg = dataclasses.replace(jmodel.TINY, lora_rank=4, n_experts=4,
                              moe_top_k=2, attn_impl="blockwise")
    jlm = jmodel.LlamaLM(cfg)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 16))
    targets = np.roll(tokens, -1, axis=1)
    variables = jax.jit(jlm.init)(jax.random.PRNGKey(3), jnp.asarray(tokens))
    rng = np.random.default_rng(8)
    lora = jax.tree_util.tree_map(
        lambda l: (0.05 * rng.standard_normal(l.shape)).astype(np.float32),
        variables["lora"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])

    def loss_fn(lora):
        logits = jlm.apply({"params": params, "lora": lora},
                           jnp.asarray(tokens))
        return jmodel.causal_nll(logits, jnp.asarray(targets)), logits

    (j_loss, j_logits), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, lora))
    tcfg = dataclasses.replace(tmodel.TINY, lora_rank=4, n_experts=4,
                               moe_top_k=2)
    tm, tl = from_flax(params, lora, tcfg, device="cpu")
    assert tm.layer_0.moe_mlp.w_gate.shape == (4, 64, 128)
    tl = {k: v.requires_grad_(True) for k, v in tl.items()}
    logits = tm(torch.as_tensor(tokens), tl)
    loss = tmodel.causal_nll(logits, torch.as_tensor(targets))
    grads = torch.autograd.grad(loss, list(tl.values()))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               atol=1e-5)
    assert abs(loss.item() - float(j_loss)) < 1e-6
    _, g_np = to_flax(None, dict(zip(tl, grads)))
    for (path, ref), (_, got) in zip(
            jax.tree_util.tree_flatten_with_path(j_grads)[0],
            jax.tree_util.tree_flatten_with_path(g_np)[0]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=str(path))
    back, _ = to_flax(tm, None)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
