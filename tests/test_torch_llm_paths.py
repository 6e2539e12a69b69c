"""The causal-LM paths of the port against the JAX package's, on the CPU,
from the same weights (carried across by ``llm/convert.py`` or
``models/convert.py``) and the same numpy-seeded data:

- the step-0 repair: ``config_from_args`` reads every argument the JAX one
  reads, and the JAX fields the port does not run raise by name;
- the federated LoRA round with the streaming cross-entropy (against the
  port's dense-loss round and the JAX streaming round), with MoE blocks,
  and ``FedLLMAPI.evaluate_per_client``;
- ``remat`` "dots"/"full"/"none" (bitwise the same loss and gradients),
  ``attn_impl="blockwise"`` against the flash path's plain version and the
  flax model, and the grouped 3-D adapter apply against flax's
  ``LoRADense``;
- the sp hub's LLM names: two ``FedAvgAPI`` rounds of ``tiny_llama``
  against the JAX engine's, and ``FedAvgAPI.evaluate_per_client``.

Tolerances: LoRA rounds 1e-4 on losses, adapters and NLLs (Adam's
normalised step at lr 1e-3 turns f32 summation-order noise into
lr-proportional differences, as ``tests/test_torch_fedllm.py``); logits
1e-5; the sp rounds 1e-5 (SGD); per-client metrics 1e-5.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import data as j_data
from fedml_tpu import model as j_model
from fedml_tpu.arguments import load_arguments as j_arguments
from fedml_tpu.llm import model as jmodel
from fedml_tpu.llm.fedllm import FedLLMAPI as JFedLLM
from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI
from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.llm import model as tmodel
from fedml_tpu_torch.llm.convert import from_flax, to_flax
from fedml_tpu_torch.llm.fedllm import FedLLMAPI as TFedLLM
from fedml_tpu_torch.models import convert as hub_convert
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvgAPI

TOL = 1e-4


# -- step 0: the options the port used to drop ----------------------------
def _dtype_name(d):
    return None if d is None else (
        str(d).split(".")[-1] if isinstance(d, torch.dtype)
        else jnp.dtype(d).name)


def test_config_from_args_reads_what_the_jax_one_reads():
    args = types.SimpleNamespace(
        model="tiny_llama", n_experts=4, moe_top_k=2,
        streaming_xent_chunk=64, llm_remat="dots", attn_impl="blockwise",
        model_dtype="bfloat16", llm_n_layers=3)
    ref = jmodel.config_from_args(args, 128)
    got = tmodel.config_from_args(args, 128)
    names = {f.name for f in dataclasses.fields(ref)}
    assert names == {f.name for f in dataclasses.fields(got)}
    for name in sorted(names):
        a, b = getattr(ref, name), getattr(got, name)
        if name in ("dtype", "param_dtype"):
            a, b = _dtype_name(a), _dtype_name(b)
        assert a == b, (name, a, b)
    assert got.n_experts == 4 and got.streaming_xent_chunk == 64


@pytest.mark.parametrize("field,over", [
    ("kv_cache_dtype", {"kv_cache_dtype": "int8"}),
    ("kv_page_tokens", {"kv_page_tokens": 16, "kv_pool_pages": 4}),
    ("ring", {"attn_impl": "ring"})])
def test_jax_fields_the_port_does_not_run_raise_by_name(field, over):
    """``attn_impl="ring"`` (ported with the seq group: tests/
    test_torch_ring.py) and the decode-cache fields (ported with serving)
    are taken as the JAX config takes them and refused where the JAX
    config refuses them."""
    dataclasses.replace(jmodel.TINY, **over)      # the JAX config takes it
    if field == "ring":
        assert dataclasses.replace(tmodel.TINY, **over).attn_impl == "ring"
        for bad in ({"attn_impl": "rings"},):
            with pytest.raises(ValueError):
                dataclasses.replace(jmodel.TINY, **bad)
            with pytest.raises(ValueError, match="attn_impl"):
                dataclasses.replace(tmodel.TINY, **bad)
        return
    got = dataclasses.replace(tmodel.TINY, **over)
    assert all(getattr(got, k) == v for k, v in over.items())
    if field == "kv_cache_dtype":
        bad = [{"kv_cache_dtype": "int4"}]
        args = types.SimpleNamespace(llm_kv_cache_dtype="int8")
        assert tmodel.config_from_args(args).kv_cache_dtype == \
            jmodel.config_from_args(args).kv_cache_dtype == "int8"
    else:
        bad = [{"kv_page_tokens": 16, "kv_pool_pages": 1},
               {"kv_page_tokens": 16}, {"kv_pool_pages": 4},
               {"kv_page_tokens": -1, "kv_pool_pages": 4}]
    for b in bad:
        with pytest.raises(ValueError) as want:
            dataclasses.replace(jmodel.TINY, **b)
        with pytest.raises(ValueError) as got_err:
            dataclasses.replace(tmodel.TINY, **b)
        assert str(got_err.value) == str(want.value)


# -- the federated LoRA round ---------------------------------------------
def _llm_args(pkg, **over):
    args = pkg.load_arguments()
    args.update(model="tiny_llama", dataset="shakespeare", seq_len=16,
                client_num_in_total=4, client_num_per_round=2, comm_round=1,
                batch_size=4, learning_rate=1e-3, random_seed=9,
                llm_max_local_steps=3, lora_rank=4, partition_method="homo",
                train_size=64, test_size=8, data_cache_dir="")
    args.update(**over)
    return pkg.init(args, should_init_logs=False)


def _carry(japi, tapi):
    params = jax.tree_util.tree_map(np.asarray, japi.base_params)
    lora = jax.tree_util.tree_map(np.asarray, japi.global_lora)
    _, tapi.global_lora = from_flax(params, lora, tapi.cfg, device="cpu",
                                    model=tapi.model)


def _assert_lora_close(ref, got_lora, tol=TOL):
    _, got = to_flax(None, got_lora)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                                 jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_allclose(b, a, atol=tol, rtol=0, err_msg=str(path))


@pytest.fixture(scope="module")
def streaming_pair():
    """The JAX and port FedLLMAPIs with ``streaming_xent_chunk`` 40 (the
    90-token vocabulary is 40 + 40 + 10 padded columns), from the same
    weights, before any round."""
    over = dict(streaming_xent_chunk=40)
    ja, ta = _llm_args(fedml_tpu, **over), _llm_args(fedml_tpu_torch, **over)
    jd, _ = j_data.load(ja)
    td, _ = t_data.load(ta)
    japi, tapi = JFedLLM(ja, jd), TFedLLM(ta, td, device="cpu")
    _carry(japi, tapi)
    return japi, tapi, ta, td


def test_streaming_round_matches_dense_and_jax(streaming_pair):
    japi, tapi, ta, td = streaming_pair
    assert tapi.xent_chunk == 40 and td.num_classes == 90
    dense = TFedLLM(_llm_args(fedml_tpu_torch), td, device="cpu")
    assert dense.xent_chunk == 0
    with torch.no_grad():
        for p, q in zip(dense.model.parameters(), tapi.model.parameters()):
            p.copy_(q)
    dense.global_lora = {k: v.clone() for k, v in tapi.global_lora.items()}
    ld = dense.train_one_round(0)["train_loss"]
    lt = tapi.train_one_round(0)["train_loss"]
    lj = japi.train_one_round(0)["train_loss"]
    assert abs(lt - ld) <= TOL and abs(lt - lj) <= TOL, (lt, ld, lj)
    _assert_lora_close(japi.global_lora, tapi.global_lora)
    for k, v in dense.global_lora.items():
        torch.testing.assert_close(tapi.global_lora[k], v, atol=TOL, rtol=0)


def test_fedllm_per_client_eval_matches_jax(streaming_pair):
    japi, tapi, _, _ = streaming_pair
    je, te = japi.evaluate_per_client(), tapi.evaluate_per_client()
    np.testing.assert_array_equal(te["clients"], je["clients"])
    np.testing.assert_allclose(te["per_client_nll"], je["per_client_nll"],
                               atol=TOL)
    for key in ("nll_mean", "nll_std", "nll_max", "nll_p90"):
        assert abs(te[key] - je[key]) <= TOL, key
    assert set(te) == set(je)


def test_moe_round_matches_jax():
    over = dict(n_experts=4, moe_top_k=2)
    ja, ta = _llm_args(fedml_tpu, **over), _llm_args(fedml_tpu_torch, **over)
    jd, _ = j_data.load(ja)
    td, _ = t_data.load(ta)
    japi, tapi = JFedLLM(ja, jd), TFedLLM(ta, td, device="cpu")
    assert "moe_mlp" in japi.base_params["layer_0"]
    _carry(japi, tapi)
    lj = japi.train_one_round(0)["train_loss"]
    lt = tapi.train_one_round(0)["train_loss"]
    assert abs(lt - lj) <= TOL, (lt, lj)
    _assert_lora_close(japi.global_lora, tapi.global_lora)
    assert abs(japi.evaluate() - tapi.evaluate()) <= TOL


def test_streaming_chunk_clamps_to_the_vocabulary():
    """A chunk wider than the vocabulary would pad the head product
    (``fedllm.py:166`` of the JAX package clamps it too)."""
    ta = _llm_args(fedml_tpu_torch, streaming_xent_chunk=8192)
    td, _ = t_data.load(ta)
    assert TFedLLM(ta, td, device="cpu").xent_chunk == td.num_classes == 90


def test_fedllm_refuses_the_mesh_regime_by_name():
    # the client and model axes run now (tests/test_torch_mesh_quant.py,
    # tests/test_torch_tp.py); a stage factor, the 3-D pipeline, is what
    # stays refused
    from fedml_tpu_torch.core.mesh import Mesh
    ta = _llm_args(fedml_tpu_torch)
    td, _ = t_data.load(ta)
    mesh = Mesh(1, 0, "cpu")
    mesh.shape["stage"] = 2
    with pytest.raises(NotImplementedError, match="mesh"):
        TFedLLM(ta, td, device="cpu", mesh=mesh)


# -- model options --------------------------------------------------------
def _flax_model(seed=0, **over):
    cfg = dataclasses.replace(jmodel.TINY, lora_rank=4, **over)
    jlm = jmodel.LlamaLM(cfg)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 24))
    variables = jax.jit(jlm.init)(jax.random.PRNGKey(seed),
                                  jnp.asarray(tokens))
    rng = np.random.default_rng(seed + 1)
    lora = jax.tree_util.tree_map(
        lambda l: (0.05 * rng.standard_normal(l.shape)).astype(np.float32),
        variables["lora"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return jlm, params, lora, tokens, np.roll(tokens, -1, axis=1)


def _port_loss_and_grads(tm, lora, tokens, targets):
    tl = {k: v.detach().clone().requires_grad_(True) for k, v in lora.items()}
    loss = tmodel.causal_nll(tm(torch.as_tensor(tokens), tl),
                             torch.as_tensor(targets))
    return loss, torch.autograd.grad(loss, list(tl.values()))


@pytest.mark.parametrize("n_experts", [0, 4])
def test_remat_policies_give_the_same_numbers(n_experts):
    """"dots" keeps the 2-D products' outputs and recomputes the rest,
    "full" recomputes each block, "none" keeps everything: the same loss
    and adapter gradients, bit for bit."""
    _, params, lora, tokens, targets = _flax_model(seed=4,
                                                   n_experts=n_experts)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(tmodel.TINY, lora_rank=4, remat=remat,
                                  n_experts=n_experts)
        tm, tl = from_flax(params, lora, cfg, device="cpu")
        out[remat] = _port_loss_and_grads(tm, tl, tokens, targets)
    for remat in ("full", "dots"):
        assert out[remat][0].item() == out["none"][0].item()
        for a, b in zip(out[remat][1], out["none"][1]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_blockwise_attention_matches_flash_and_flax():
    jlm, params, lora, tokens, targets = _flax_model(seed=5,
                                                     attn_impl="blockwise")
    j_logits = jax.jit(jlm.apply)({"params": params, "lora": lora},
                                  jnp.asarray(tokens))
    res = {}
    for impl in ("blockwise", "flash"):
        cfg = dataclasses.replace(tmodel.TINY, lora_rank=4, attn_impl=impl)
        tm, tl = from_flax(params, lora, cfg, device="cpu")
        with torch.no_grad():
            res[impl] = tm(torch.as_tensor(tokens), tl).numpy()
        res[impl + "_grads"] = _port_loss_and_grads(tm, tl, tokens,
                                                    targets)[1]
    np.testing.assert_allclose(res["blockwise"], np.asarray(j_logits),
                               atol=1e-5)
    np.testing.assert_allclose(res["blockwise"], res["flash"], atol=1e-5)
    for a, b in zip(res["blockwise_grads"], res["flash_grads"]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * b.abs().max().item())


def test_grouped_adapter_apply_matches_flax():
    """Adapters with a leading axis aligned with x's batch (A (B, in, r),
    B (B, r, out)) against flax's LoRADense, and against each row run with
    its own 2-D adapters."""
    b, s, din, dout, r = 3, 5, 12, 10, 4
    rng = np.random.default_rng(6)
    x = rng.standard_normal((b, s, din)).astype(np.float32)
    jd = jmodel.LoRADense(features=dout, rank=r, alpha=8.0)
    variables = jd.init(jax.random.PRNGKey(0), jnp.asarray(x))
    a3 = (0.1 * rng.standard_normal((b, din, r))).astype(np.float32)
    b3 = (0.1 * rng.standard_normal((b, r, dout))).astype(np.float32)
    ref = jd.apply({"params": variables["params"],
                    "lora": {"A": jnp.asarray(a3), "B": jnp.asarray(b3)}},
                   jnp.asarray(x))
    td = tmodel.LoRADense(din, dout, r, 8.0, torch.float32, torch.float32)
    td.path = "p"
    with torch.no_grad():
        td.base.kernel.copy_(torch.tensor(
            np.asarray(variables["params"]["base"]["kernel"])))
    got = td(torch.tensor(x), {"p/A": torch.tensor(a3),
                               "p/B": torch.tensor(b3)})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    rows = [td(torch.tensor(x[i:i + 1]), {"p/A": torch.tensor(a3[i]),
                                          "p/B": torch.tensor(b3[i])})
            for i in range(b)]
    np.testing.assert_allclose(got.detach().numpy(),
                               torch.cat(rows).detach().numpy(), atol=1e-6)


# -- the sp hub's LLM names -------------------------------------------------
HUB = dict(model="tiny_llama", dataset="shakespeare", seq_len=16,
           client_num_in_total=4, client_num_per_round=2, comm_round=2,
           batch_size=4, learning_rate=0.1, train_size=48, test_size=8,
           random_seed=3, partition_method="homo", data_cache_dir="",
           frequency_of_the_test=1)


@pytest.mark.parametrize("name", ["transformer", "gpt", "llama",
                                  "tiny_llama"])
def test_hub_creates_the_causal_lm(name):
    args = t_arguments().update(model=name, llm_n_layers=1)
    tm = t_model.create(args, 90)
    assert tm.task == "lm" and tm.input_dtype == torch.int32
    cfg = tm.module.cfg
    assert cfg.remat == "none" and cfg.param_dtype == torch.float32
    assert tm.input_shape == (min(cfg.max_seq_len, 512),)
    assert all(p.dtype == torch.float32 for p in tm.module.parameters())
    if name == "llama":
        assert (cfg.dim, cfg.n_heads, cfg.ffn_dim) == (4096, 32, 11008)
        assert cfg.dtype == torch.bfloat16
        return
    jargs = j_arguments().update(model=name, llm_n_layers=1)
    jm = j_model.create(jargs, 90)
    params = tm.init(torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    flat = {"/".join(getattr(p, "key", str(p)) for p in path): v.shape
            for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    kinds = hub_convert.param_kinds(tm.module)
    assert {kinds[n][1]: tuple(t.shape) for n, t in params.items()} == flat
    out = tm.apply(params, torch.zeros((2, 8), dtype=torch.int32))
    assert out.shape == (2, 8, 90) and torch.isfinite(out).all()


def test_hub_refuses_recompute_under_torch_func():
    with pytest.raises(NotImplementedError, match="llm_remat"):
        t_model.create(t_arguments().update(model="tiny_llama",
                                            llm_remat="dots"), 90)


def _hub_pair(cfg):
    ja = j_arguments().update(**cfg)
    jd, jn = j_data.load(ja)
    japi = JFedAvgAPI(ja, None, jd, j_model.create(ja, jn))
    ta = t_arguments().update(**cfg)
    td, tn = t_data.load(ta)
    tm = t_model.create(ta, tn)
    tapi = TFedAvgAPI(ta, "cpu", td, tm)
    tapi.state = tapi.state.replace(global_params=hub_convert.from_flax(
        jax.device_get(japi.state.global_params), tm, device="cpu"))
    return japi, tapi, tm


def test_tiny_llama_sp_rounds_and_per_client_eval_match_jax():
    japi, tapi, tm = _hub_pair(HUB)
    for r in range(2):
        jl = float(japi.train_one_round(r)["train_loss"])
        tl = float(tapi.train_one_round(r)["train_loss"])
        assert abs(jl - tl) <= 1e-5, (r, jl, tl)
    ref = jax.device_get(japi.state.global_params)
    got = hub_convert.to_flax(tapi.state.global_params, tm)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                                 jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5, rtol=0,
                                   err_msg=str(path))
    np.testing.assert_allclose(tapi.evaluate(), japi.evaluate(), atol=1e-5)
    je = japi.evaluate_per_client(batch_size=4)
    te = tapi.evaluate_per_client(batch_size=4)
    assert set(te) == set(je)
    for key in ("per_client_acc", "per_client_loss"):
        np.testing.assert_allclose(te[key], je[key], atol=1e-5)
    for key in ("acc_mean", "acc_std", "acc_min", "acc_p10"):
        assert abs(te[key] - je[key]) <= 1e-5, key


@pytest.mark.parametrize("split", ["train", "test"])
def test_per_client_eval_matches_jax_on_classification(split):
    cfg = dict(dataset="synthetic", num_classes=10, input_shape=(28, 28, 1),
               model="lr", client_num_in_total=6, client_num_per_round=3,
               comm_round=1, batch_size=16, learning_rate=0.1,
               train_size=240, test_size=60, random_seed=4,
               data_cache_dir="")
    japi, tapi, _ = _hub_pair(cfg)
    japi.train_one_round(0)
    tapi.train_one_round(0)
    je = japi.evaluate_per_client(split=split, batch_size=16)
    te = tapi.evaluate_per_client(split=split, batch_size=16)
    for key in ("per_client_acc", "per_client_loss"):
        np.testing.assert_allclose(te[key], je[key], atol=1e-5)
