"""Tensor parallelism on the port's ``client × model`` mesh, on 4 gloo
ranks (2 × 2 and 1 × 4) on the CPU, against the JAX package:

- ``FedLLMAPI(mesh=make_mesh2d(...))``, its rounds, eval and
  ``evaluate_per_client``, against the JAX single-device
  ``FedLLMAPI`` (the reference ``tests/test_llm.py::
  test_fedllm_mesh_matches_single_device`` holds the JAX mesh regime to),
  from the same weights, to the port's LoRA limit 1e-4 at lr 1e-3
  (``tests/test_torch_fedllm.py``): tiny f32 Llama with ``n_heads`` 4 at
  ``n_kv_heads`` 2 (split over 2) and 4 (split over 4), and the GQA case
  ``n_kv_heads`` 2 < ``m`` 4 (wk/wv whole, each rank its query heads' KV
  head);
- right after init no rank holds a whole weight-sized base tensor but
  the recorded divergences, and every rank holds within 25% of the mean
  (``tests/test_llm.py::test_mesh_sharded_init_and_estimator_bound``);
- ``param_sharding_rules`` leaf by leaf against the JAX rules, the
  recorded divergences (``llm/model.py::TP_DIVERGENCES``) apart;
- greedy decode over the tensor-parallel model against the JAX
  unsharded decode (``tests/test_serving_plane.py::
  test_tp_sharded_decode_matches_unsharded``), dense and int8 KV, token
  for token, the cache holding the rank's KV heads;
- ``MoEMLP(mesh=...)`` (experts over the model group) against the JAX
  ``MoEMLP``, atol 2e-5 rtol 1e-4 (``tests/test_moe.py:75``);
- the memory estimators equal the JAX package's on the same layouts (the
  chip table apart: the port's holds the H100 only);
- ``CausalLMTrainer(mesh=...)`` with a mesh of one rank: its history is
  bitwise the ``mesh=None`` run's.

On the CPU the attention runs the kernels' plain versions.  One spawn of 4
ranks runs every multi-rank case of the file."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import data as j_data
from fedml_tpu.core import memory_estimate as j_mem
from fedml_tpu.core.mesh import make_mesh as j_make_mesh
from fedml_tpu.llm.fedllm import FedLLMAPI as JFedLLM
from fedml_tpu.llm.model import TINY as J_TINY
from fedml_tpu.llm.model import LlamaLM as JLlama
from fedml_tpu.llm.model import param_sharding_rules as j_rules
from fedml_tpu.llm.moe import MoEMLP as JMoE
from fedml_tpu.serving.templates.openai_compat import \
    _build_cached_decode as j_cached_decode

from fedml_tpu_torch import data as t_data
from fedml_tpu_torch.core import memory_estimate as t_mem
from fedml_tpu_torch.core.mesh import Mesh
from fedml_tpu_torch.llm.convert import to_flax
from fedml_tpu_torch.llm.model import TINY as T_TINY
from fedml_tpu_torch.llm.model import TP_DIVERGENCES, param_sharding_rules
from fedml_tpu_torch.llm.trainer import CausalLMTrainer as TTrainer
from fedml_tpu_torch.simulation.mesh.launch import spawn

from .torch_mesh_parity import SPAWN_TIMEOUT

N = 4
TOL = 1e-4
ROUNDS = 2
#: (mesh shape, config overrides): n_kv_heads split, split over 4, and
#: the GQA case n_kv_heads < m
FEDLLM = {"2x2": ("2,2", {}),
          "1x4": ("1,4", {"llm_n_kv_heads": 4}),
          "1x4_gqa": ("1,4", {})}
DECODE_CFG = dict(n_layers=2, vocab_size=64, dim=32, n_heads=4, n_kv_heads=4,
                  ffn_dim=64, max_seq_len=32)
PROMPT = [5, 17, 42, 7]
DECODES = [(kv, shape) for kv in ("native", "int8") for shape in ("1,4",
                                                                  "2,2")]
MOE_DIMS = (16, 32, 8, 2)          # dim, ffn, experts, top-k
MOE_SHAPES = ("1,4", "2,2")


def _args(pkg, **over):
    args = pkg.load_arguments()
    args.update(model="tiny_llama", dataset="shakespeare", seq_len=32,
                client_num_in_total=6, client_num_per_round=3,
                comm_round=ROUNDS, batch_size=4, learning_rate=1e-3,
                random_seed=9, llm_max_local_steps=2, lora_rank=4,
                partition_method="homo", train_size=96, test_size=8,
                data_cache_dir="")
    args.update(**over)
    return pkg.init(args, should_init_logs=False)


def _j_decode(kv):
    cfg = dataclasses.replace(J_TINY, attn_impl="blockwise",
                              kv_cache_dtype=kv, **DECODE_CFG)
    lm = JLlama(cfg)
    buf = jnp.zeros((1, cfg.max_seq_len), jnp.int32).at[0, :4].set(
        jnp.asarray(PROMPT, jnp.int32))
    params = lm.init(jax.random.PRNGKey(0), buf)["params"]
    prefill, step, _ = j_cached_decode(lm, 0, 1.0)
    key = jax.random.PRNGKey(0)
    tok, cache = prefill(params, None, buf, jnp.int32(4), key,
                         jnp.float32(0.0))
    toks = [int(tok)]
    for i in range(4, 10):
        tok, cache = step(params, None, cache, tok, jnp.int32(i), key,
                          jnp.float32(0.0))
        toks.append(int(tok))
    return jax.tree_util.tree_map(np.asarray, params), toks


_RUNS = {}


def _runs():
    if _RUNS:
        return _RUNS
    calls, refs = [], {}
    for name, (shape, over) in FEDLLM.items():
        key = tuple(sorted(over.items()))
        if key not in refs:
            # the single-device reference does not depend on the mesh
            ja = _args(fedml_tpu, **over)
            jd, _ = j_data.load(ja)
            japi = JFedLLM(ja, jd)
            params = jax.tree_util.tree_map(np.asarray, japi.base_params)
            lora0 = jax.tree_util.tree_map(np.asarray, japi.global_lora)
            losses = [japi.train_one_round(r)["train_loss"]
                      for r in range(ROUNDS)]
            refs[key] = (params, lora0, dict(
                losses=losses, eval=japi.evaluate(),
                lora=jax.tree_util.tree_map(np.asarray, japi.global_lora)))
            if name == "2x2":       # and 1x4_gqa, the same config
                refs[key][2]["per_client"] = np.asarray(
                    japi.evaluate_per_client()["per_client_nll"])
        params, lora0, ref = refs[key]
        _RUNS[name] = dict(ref)
        cfg = {k: v for k, v in vars(_args(fedml_tpu_torch, **over)).items()
               if not k.startswith("_")}
        calls.append(("tests.torch_mesh_ranks:tp_fedllm",
                      (cfg, shape, params, lora0, ROUNDS)))
    for kv, shape in DECODES:
        params, toks = _j_decode(kv)
        _RUNS[("decode", kv, shape)] = dict(tokens=toks)
        calls.append(("tests.torch_mesh_ranks:tp_decode",
                      (params, dict(DECODE_CFG, kv_cache_dtype=kv), shape,
                       PROMPT, 7)))
    dim, ffn, e, k = MOE_DIMS
    x = np.random.default_rng(0).standard_normal((2, 16, dim)).astype(
        np.float32)
    jm = JMoE(dim=dim, ffn_dim=ffn, n_experts=e, top_k=k)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref, _ = jm.apply(variables, jnp.asarray(x), mutable=["losses"])
    _RUNS["moe_ref"] = np.asarray(ref)
    mparams = jax.tree_util.tree_map(np.asarray, variables["params"])
    for shape in MOE_SHAPES:
        calls.append(("tests.torch_mesh_ranks:tp_moe",
                      (mparams, x, MOE_DIMS, shape)))
    ranks = spawn("tests.torch_mesh_ranks:several_each", N, (calls,),
                  timeout=SPAWN_TIMEOUT)
    keys = list(FEDLLM) + [("decode",) + d for d in DECODES] + \
        [("moe", s) for s in MOE_SHAPES]
    for i, key in enumerate(keys):
        _RUNS.setdefault(key, {})["ranks"] = [r[i] for r in ranks]
    return _RUNS


@pytest.mark.parametrize("case", list(FEDLLM))
def test_tp_fedllm_matches_jax_single_device(case):
    run = _runs()[case]
    for res in run["ranks"]:
        for r, (jl, tl) in enumerate(zip(run["losses"], res["losses"])):
            assert abs(jl - tl) <= TOL * max(1.0, abs(jl)), (r, jl, tl)
        _, got = to_flax(None, {k: torch.as_tensor(v)
                                for k, v in res["lora"].items()})
        flat_ref = jax.tree_util.tree_flatten_with_path(run["lora"])[0]
        flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
        for (path, a), (_, b) in zip(flat_ref, flat_got):
            np.testing.assert_allclose(b, a, atol=TOL, rtol=0,
                                       err_msg=str(path))
        assert abs(res["eval"] - run["eval"]) <= TOL
        if "per_client" in run:
            np.testing.assert_allclose(res["per_client"], run["per_client"],
                                       atol=TOL, rtol=0)


@pytest.mark.parametrize("case", list(FEDLLM))
def test_tp_init_holds_no_whole_weight_and_is_balanced(case):
    shape, over = FEDLLM[case]
    m = int(shape.split(",")[1])
    ranks = _runs()[case]["ranks"]
    for res in ranks:
        assert not res["stray"], res["stray"]
        for name, full in res["full"].items():
            local = res["local"][name]
            if len(full) < 2:
                assert tuple(local) == tuple(full)
            elif name in res["dims"]:
                assert int(np.prod(local)) * m == int(np.prod(full)), name
            elif name == "tok_embed.embedding":
                # whole by a recorded divergence: the model factor does
                # not divide the vocabulary (Shakespeare's 90 characters)
                assert full[0] % m, name
            else:
                # ... or wk/wv when it does not divide n_kv_heads
                assert name.split(".")[-3] in ("wk", "wv"), name
                assert res["kv_heads"] == 1
    held = np.array([r["held"] for r in ranks], float)
    assert held.max() <= 1.25 * held.mean(), held


@pytest.mark.parametrize("cfg_over,m", [
    ({}, 2), ({}, 4), (dict(n_kv_heads=4), 4), (dict(lora_rank=4), 4),
    (dict(n_experts=4), 4), (dict(n_experts=4), 2),
    (dict(vocab_size=250), 4)])
def test_param_sharding_rules_match_jax(cfg_over, m):
    jcfg = dataclasses.replace(J_TINY, **cfg_over)
    tcfg = dataclasses.replace(T_TINY, **cfg_over)
    jmesh = j_make_mesh(client=8 // m, model=m)
    tokens = jnp.zeros((1, 8), jnp.int32)
    abstract = jax.eval_shape(JLlama(jcfg).init, jax.random.PRNGKey(0),
                              tokens)["params"]
    want = {"/".join(str(getattr(p, "key", p)) for p in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                j_rules(abstract, jmesh),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    shapes = {"/".join(str(getattr(p, "key", p)) for p in path): l.shape
              for path, l in jax.tree_util.tree_flatten_with_path(
                  abstract)[0]}
    got = param_sharding_rules(shapes, m, tcfg)
    assert set(got) == set(want)
    differ = []
    for name in want:
        w = tuple(want[name]) if any(want[name]) else ()
        if got[name] != w:
            differ.append(name)
    for name in differ:
        parts = name.split("/")
        if "moe_mlp" in parts:
            key = ("moe_mlp/router" if "router" in parts
                   else "moe_mlp/w_gate,w_up")
            assert parts[-1] in ("kernel", "w_gate", "w_up"), name
        elif parts[0] in ("tok_embed", "lm_head"):
            key = parts[0]
            assert tcfg.vocab_size % m or tcfg.dim % m, name
        else:
            key = "wk/wv"
            assert parts[2] in ("wk", "wv") and tcfg.n_kv_heads % m, name
        assert key in TP_DIVERGENCES, name


@pytest.mark.parametrize("kv,shape", DECODES)
def test_tp_greedy_decode_matches_jax_unsharded(kv, shape):
    run = _runs()[("decode", kv, shape)]
    m = int(shape.split(",")[1])
    for res in run["ranks"]:
        assert res["tokens"] == run["tokens"]
        assert res["cache_heads"] == DECODE_CFG["n_kv_heads"] // m


@pytest.mark.parametrize("shape", MOE_SHAPES)
def test_moe_expert_parallel_matches_jax(shape):
    run = _runs()[("moe", shape)]
    m = int(shape.split(",")[1])
    for res in run["ranks"]:
        assert res["experts"] == MOE_DIMS[2] // m
        np.testing.assert_allclose(res["out"], _RUNS["moe_ref"], atol=2e-5,
                                   rtol=1e-4)


def test_memory_estimators_match_jax():
    for kw in (dict(n_params=6.74e9, n_lora_params=4 * 32 * 2 * 4096 * 16,
                    n_clients=8, n_chips=4, model_shards=2),
               dict(n_params=1e9, n_lora_params=1e6, n_clients=32,
                    n_chips=8, model_shards=4, remat="dots"),
               dict(n_params=3e8, n_lora_params=2e5, n_clients=5, n_chips=1,
                    model_shards=1, remat="none", seq_len=512)):
        want = j_mem.estimate_fedllm_memory(j_mem.FedLLMLayout(**kw))
        got = t_mem.estimate_fedllm_memory(t_mem.FedLLMLayout(**kw))
        assert got == want
        budget = t_mem.HBM_PER_CHIP["h100"]
        assert t_mem.fits(t_mem.FedLLMLayout(**kw), "H100 80GB HBM3") == \
            (want["total"] <= budget)
    for kw in (dict(n_params=1e9, mesh_shape=(8, 1), clients_per_round=8,
                    algorithm="fedopt", collective_precision="int8",
                    param_bytes=2),
               dict(n_params=1e9, mesh_shape=(4, 2), clients_per_round=8,
                    algorithm="scaffold"),
               dict(n_params=7e9, mesh_shape=(2, 2, 2), stage_fraction=0.9,
                    max_model_parallel=4, algorithm="mime",
                    collective_precision="bf16")):
        want = j_mem.estimate_mesh_state_memory(j_mem.MeshStateLayout(**kw))
        got = t_mem.estimate_mesh_state_memory(t_mem.MeshStateLayout(**kw))
        assert got == want
        for budget in (1 * t_mem.GIB, 60 * t_mem.GIB):
            assert t_mem.mesh_state_fits(t_mem.MeshStateLayout(**kw),
                                         budget) == \
                j_mem.mesh_state_fits(j_mem.MeshStateLayout(**kw), budget)
        fk = dict(data_bytes=1e8, cohort_bytes=3e7, members=2,
                  rounds_fused=4)
        assert t_mem.estimate_round_footprint(
            t_mem.MeshStateLayout(**kw), **fk) == \
            j_mem.estimate_round_footprint(j_mem.MeshStateLayout(**kw), **fk)
    lk = dict(clients_per_round=8, algorithm="fedopt",
              collective_precision="int8", param_bytes=2)
    for budget in (12 * t_mem.GIB, 60 * t_mem.GIB):
        assert t_mem.largest_runnable_params(
            budget, (2, 4), [0.5e9, 1.075e9, 3e9, 7e9], **lk) == \
            j_mem.largest_runnable_params(
                budget, (2, 4), [0.5e9, 1.075e9, 3e9, 7e9], **lk)
    assert set(t_mem.HBM_PER_CHIP) == {"h100"}


def test_trainer_on_a_mesh_of_one_rank_is_bitwise_the_plain_run():
    """``CausalLMTrainer(mesh=...)`` takes the mesh as the JAX trainer
    does, never reads it, and runs on its device."""
    args = fedml_tpu_torch.load_arguments()
    args.update(model="tiny_llama", dataset="shakespeare", seq_len=16,
                batch_size=4, learning_rate=1e-3, random_seed=9,
                lora_rank=4, partition_method="homo", train_size=12,
                test_size=8, data_cache_dir="", client_num_in_total=2,
                client_num_per_round=2, epochs=1,
                gradient_accumulation_steps=2, max_grad_norm=0.5,
                warmup_steps=1, lr_scheduler_type="cosine", max_steps=3)
    args = fedml_tpu_torch.init(args, should_init_logs=False)
    ds, _ = t_data.load(args)
    plain = TTrainer(args, ds, device="cpu")
    meshed = TTrainer(args, ds, device="cuda", mesh=Mesh(1, 0, "cpu"))
    assert meshed.device == torch.device("cpu")
    a, b = plain.train(), meshed.train()
    assert a == b
    assert plain.step_losses == meshed.step_losses
    for k in plain.lora:
        assert torch.equal(plain.lora[k], meshed.lora[k])
