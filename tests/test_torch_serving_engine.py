"""The port's continuous-batching engine, page pool and adapter bank against
the JAX package's, on the CPU, from the same weights and numpy-seeded
prompts (``TINY`` widths, f32, LoRA rank 4):

- the engine ≡ the JAX ``ContinuousBatchingEngine`` request for request at 4
  slots with 8 requests, horizons 1 and 3, dense and paged (8-token pages,
  8-token prefill chunks);
- the multi-tenant engine ≡ the JAX one with saturated adapters mixed with
  base traffic;
- ``paged_kv.py``'s copy ≡ the original on one sequence of reserve, share,
  release, insert, lookup and evict calls;
- sampled requests draw the same tokens in the engine as in ``generate``;
- copy-on-write re-registration, evict-while-live, a full bank, an adapter
  read from a checkpoint of the port's format, page exhaustion (parks and
  completes), every page free after the drain, the weight swap, and the
  server's engine mode over HTTP.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.llm import model as jm
from fedml_tpu.serving import paged_kv as j_pkv
from fedml_tpu.serving.batching import ContinuousBatchingEngine as JEngine
from fedml_tpu_torch.core.checkpoint import RoundCheckpointer
from fedml_tpu_torch.llm import model as tm
from fedml_tpu_torch.llm.convert import from_flax, lora_from_flax
from fedml_tpu_torch.serving import paged_kv as t_pkv
from fedml_tpu_torch.serving.adapters import AdapterRegistry, BankFullError
from fedml_tpu_torch.serving.batching import ContinuousBatchingEngine
from fedml_tpu_torch.serving.templates.openai_compat import (
    OpenAICompatServer, generate)

BUF = 40
MAX_SEQ = 48


def _saturated(lora_zeros, seed):
    """A and B both non-zero: a zero B would let a wrong-row gather pass."""
    flat, treedef = jax.tree_util.tree_flatten(lora_zeros)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        (0.5 * rng.standard_normal(leaf.shape)).astype(np.float32)
        for leaf in flat])


@pytest.fixture(scope="module")
def lm():
    over = dict(max_seq_len=MAX_SEQ, attn_impl="blockwise", lora_rank=4,
                vocab_size=258)
    jcfg = dataclasses.replace(jm.TINY, **over)
    tcfg = dataclasses.replace(tm.TINY, **over)
    jmodel = jm.LlamaLM(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8), jnp.int32))
    params_np = jax.tree_util.tree_map(np.asarray, variables["params"])
    tmodel, _ = from_flax(params_np, None, tcfg, device="cpu")
    jloras = {f"a{i}": _saturated(variables["lora"], 20 + i)
              for i in range(3)}
    tloras = {k: lora_from_flax(v, "cpu") for k, v in jloras.items()}
    rng = np.random.default_rng(4)
    # lengths from 3 to 30: several 8-token chunks and pages per prompt
    prompts = [list(map(int, rng.integers(0, 256, n)))
               for n in (3, 30, 9, 17, 5, 24, 12, 28)]
    return dict(jmodel=jmodel, params=variables["params"], tmodel=tmodel,
                jloras=jloras, tloras=tloras, prompts=prompts,
                zero=jax.tree_util.tree_map(np.zeros_like,
                                            variables["lora"]))


def _drain(q):
    return [t for t in iter(lambda: q.get(timeout=120), None)]


def _run(engine, prompts, budgets, adapters=None):
    adapters = adapters or [None] * len(prompts)
    qs = [engine.submit(p, max_new_tokens=b, adapter=a)
          for p, b, a in zip(prompts, budgets, adapters)]
    return [_drain(q) for q in qs]


BUDGETS = [10, 6, 12, 4, 9, 7, 11, 5]


@pytest.fixture(scope="module")
def jax_tokens(lm):
    """The JAX engine's greedy tokens, dense horizon 1 and paged horizon 3
    (each JAX configuration is itself pinned ≡ its others by the JAX
    package's tests)."""
    out = {}
    for name, kw in (("dense", {}), ("paged", dict(kv_page_tokens=8,
                                                   prefill_chunk_tokens=8,
                                                   horizon=3))):
        eng = JEngine(lm["jmodel"], lm["params"], slots=4, buf_len=BUF,
                      adapter_slots=2, **kw)
        try:
            out[name] = _run(eng, lm["prompts"], BUDGETS)
        finally:
            eng.stop()
    assert out["dense"] == out["paged"]
    return out["dense"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("horizon", [1, 3])
def test_engine_matches_jax_engine(lm, jax_tokens, paged, horizon):
    kw = dict(kv_page_tokens=8, prefill_chunk_tokens=8) if paged else {}
    eng = ContinuousBatchingEngine(lm["tmodel"], None, slots=4, buf_len=BUF,
                                   horizon=horizon, **kw)
    try:
        got = _run(eng, lm["prompts"], BUDGETS)
        stats = eng.kv_stats()
    finally:
        eng.stop()
    assert got == jax_tokens
    if paged:
        assert stats["prefill_chunks"] >= sum(
            -(-len(p) // 8) for p in lm["prompts"])
        assert stats["pages_free"] == stats["pool_pages"] - 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_multi_tenant_engine_matches_jax(lm, paged):
    """Three saturated adapters and base traffic in one batch ≡ the JAX
    multi-tenant engine, request for request."""
    kw = dict(kv_page_tokens=8, prefill_chunk_tokens=8) if paged else {}
    adapters = ["a0", None, "a1", "a2", "a0", None, "a2", "a1"]
    jeng = JEngine(lm["jmodel"], lm["params"], slots=4, buf_len=BUF,
                   adapter_slots=6, **kw)
    teng = ContinuousBatchingEngine(lm["tmodel"], None, slots=4,
                                    buf_len=BUF, adapter_slots=6, **kw)
    try:
        for name in lm["jloras"]:
            jeng.registry.register(name, lm["jloras"][name])
            teng.registry.register(name, lm["tloras"][name])
        want = _run(jeng, lm["prompts"], BUDGETS, adapters)
        got = _run(teng, lm["prompts"], BUDGETS, adapters)
    finally:
        jeng.stop()
        teng.stop()
    assert got == want
    # the adapters matter: base and a0 part on the same prompt
    assert want[0] != _run_generate(lm, lm["prompts"][0], BUDGETS[0], None)
    assert teng.serve_stats["requests"] == {"a0": 2, "a1": 2, "a2": 2,
                                            "base": 2}


def _run_generate(lm, prompt, budget, adapter, **kw):
    lora = lm["tloras"][adapter] if adapter else None
    return generate(None, None, prompt, max_new_tokens=budget, buf_len=BUF,
                    model=lm["tmodel"], lora=lora, **kw)


def test_sampled_engine_draws_as_generate(lm):
    """A sampled request draws the same tokens through the engine (dense
    and paged, horizon 2) as through ``generate``: one generator per
    request, seeded from its seed, consumed in the same order."""
    prompts = lm["prompts"][:6]
    want = [_run_generate(lm, p, 9, None, temperature=0.8, seed=i)
            for i, p in enumerate(prompts)]
    for kw in ({}, dict(kv_page_tokens=8, prefill_chunk_tokens=8)):
        eng = ContinuousBatchingEngine(lm["tmodel"], None, slots=3,
                                       buf_len=BUF, horizon=2, **kw)
        try:
            qs = [eng.submit(p, max_new_tokens=9, temperature=0.8, seed=i)
                  for i, p in enumerate(prompts)]
            assert [_drain(q) for q in qs] == want
        finally:
            eng.stop()
    greedy = [_run_generate(lm, p, 9, None) for p in prompts]
    assert want != greedy


def test_paged_kv_copy_matches_original():
    """One sequence of pool and prefix-cache calls on the port's copy and
    on the original: the same returns, stats and errors."""
    def drive(pkv):
        log = []
        pool = pkv.PagedBlockPool(10)
        cache = pkv.PagedPrefixCache(capacity=2, page_tokens=4, pool=pool)
        params, tok = object(), object()
        a = pool.reserve(3)
        b = pool.reserve(2)
        log += [a, b, pool.pages_free]
        pool.share(a[:2])
        cache.insert(list(range(12)), a, params, tok)
        cache.insert(list(range(40, 48)), b, params, tok)
        pool.release(a)
        pool.release(b)
        log += [cache.lookup(list(range(12)) + [7], params, tok),
                cache.lookup(list(range(12)), params, object()),
                cache.lookup([1, 2], params, tok), pool.pages_free]
        cache.insert(list(range(60, 72)), pool.reserve(3), params, tok)
        log.append(len(cache))
        try:
            pool.reserve(20)
        except pkv.PageExhaustedError as e:
            log.append(str(e))
        log += [cache.evict_for_pages(8), pool.pages_free]
        cache.lookup([0], object(), tok)          # params swap: flush
        log += [pool.pages_free, dict(pool.stats), dict(cache.stats)]
        return log

    assert drive(t_pkv) == drive(j_pkv)


def test_copy_on_write_and_evict_while_live(lm):
    """Re-registering a pinned name moves it to a fresh row: the in-flight
    stream finishes on the old weights, the next request gets the new ones.
    Evicting a pinned adapter fails new requests at once while the stream
    finishes on its zombie row, which is reclaimed after."""
    t = lm["tloras"]
    eng = ContinuousBatchingEngine(lm["tmodel"], None, slots=2, buf_len=BUF,
                                   adapter_slots=4)
    reg = eng.registry
    try:
        reg.register("a1", t["a1"])
        q = eng.submit([7, 7], max_new_tokens=18, adapter="a1")
        reg.register("a1", t["a2"])                 # pinned -> fresh row
        assert reg.stats["copy_on_write"] == 1
        assert _drain(q) == _run_generate(lm, [7, 7], 18, "a1")
        assert eng.generate([7, 7], max_new_tokens=8, adapter="a1") == \
            _run_generate(lm, [7, 7], 8, "a2")
        reg.register("a0", t["a0"])
        q = eng.submit([5, 17, 42], max_new_tokens=20, adapter="a0")
        reg.evict("a0")
        with pytest.raises(KeyError):
            eng.submit([1], adapter="a0")
        assert _drain(q) == _run_generate(lm, [5, 17, 42], 20, "a0")
        assert reg.stats["rows_reclaimed"] >= 2
        reg.register("fresh", t["a0"])              # the zombie row is free
    finally:
        eng.stop()


def test_bank_full_and_register_from_checkpoint(lm, tmp_path):
    """A capacity-4 bank holds 3 adapters (``BankFullError`` on the 4th,
    the evicted row reused); adapters read from the port's checkpoints,
    bare and population-stacked with a ``lora/`` prefix, serve as their
    source does."""
    t = lm["tloras"]
    reg = AdapterRegistry(lm["tmodel"], capacity=4)
    for name, tree in t.items():
        reg.register(name, tree)
    with pytest.raises(BankFullError):
        reg.register("overflow", t["a0"])
    reg.evict("a1")
    assert 1 <= reg.register("overflow", t["a0"]) < 4
    with pytest.raises(KeyError):
        reg.acquire("a1")
    bad = {k: torch.zeros(v.shape + (2,)) for k, v in t["a0"].items()}
    with pytest.raises(ValueError):
        reg.register("bad", bad)

    ckpt = RoundCheckpointer(str(tmp_path / "bare"))
    ckpt.save(5, t["a2"])
    ckpt = RoundCheckpointer(str(tmp_path / "pop"))
    ckpt.save(2, {f"lora/{k}": torch.stack([t["a0"][k], t["a1"][k]])
                  for k in t["a0"]})
    eng = ContinuousBatchingEngine(lm["tmodel"], None, slots=2, buf_len=BUF,
                                   adapter_slots=4)
    try:
        eng.registry.register_from_checkpoint("bare", str(tmp_path / "bare"))
        eng.registry.register_from_checkpoint("m1", str(tmp_path / "pop"),
                                              member=1)
        for name, src in (("bare", "a2"), ("m1", "a1")):
            assert eng.generate([5, 17, 42], max_new_tokens=8,
                                adapter=name) == \
                _run_generate(lm, [5, 17, 42], 8, src)
    finally:
        eng.stop()
    with pytest.raises(FileNotFoundError):
        AdapterRegistry(lm["tmodel"], capacity=2).register_from_checkpoint(
            "missing", str(tmp_path / "empty"))


def test_paged_sharing_parking_and_release(lm):
    """Prefix pages are shared (refcounts) with the same output; a pool too
    small for every slot parks requests that then complete as the dense
    engine's; an unservable request fails open; every page is free after
    the drain."""
    model = lm["tmodel"]
    prompt = list(range(3, 27))                     # 3 full pages
    eng = ContinuousBatchingEngine(model, None, slots=2, buf_len=BUF,
                                   kv_page_tokens=8, prefix_cache_slots=4)
    try:
        first = eng.generate(prompt, max_new_tokens=6)
        assert eng.generate(prompt, max_new_tokens=6) == first
        kv = eng.kv_stats()
        assert kv["prefix"]["hits"] >= 1 and kv["pages_shared"] > 0
    finally:
        eng.stop()
    prompts = [[i + 1, i + 2, i + 3] for i in range(6)]
    dense = ContinuousBatchingEngine(model, None, slots=4, buf_len=BUF)
    # 4 slots want 2 pages each; 5 usable pages: the rest must park
    eng = ContinuousBatchingEngine(model, None, slots=4, buf_len=BUF,
                                   kv_page_tokens=8, kv_pool_pages=6)
    try:
        assert _run(eng, prompts, [12] * 6) == _run(dense, prompts, [12] * 6)
        assert eng.page_pool.stats["exhausted"] > 0
        kv = eng.kv_stats()
        assert kv["pages_free"] == kv["pool_pages"] - 1
    finally:
        dense.stop()
        eng.stop()
    # 5 pages wanted, 2 usable: failed open, and the engine serves on
    eng = ContinuousBatchingEngine(model, None, slots=2, buf_len=BUF,
                                   kv_page_tokens=8, kv_pool_pages=3)
    try:
        assert _drain(eng.submit(list(range(1, 39)), max_new_tokens=8)) == []
        assert len(eng.generate([5, 17, 42], max_new_tokens=4)) == 4
        kv = eng.kv_stats()
        assert kv["pages_free"] == kv["pool_pages"] - 1
    finally:
        eng.stop()


def test_engine_weight_swap_and_step_programs(lm):
    """``update_params`` lands between requests: the next request decodes
    with the new weight dict, as a fresh ``generate`` on it does; the step
    programs run on their resting buffers."""
    model = lm["tmodel"]
    w1 = {n: p.detach() * 1.05 for n, p in model.named_parameters()}
    eng = ContinuousBatchingEngine(model, None, slots=2, buf_len=BUF,
                                   prefix_cache_slots=2)
    try:
        before = eng.generate([5, 17, 42], max_new_tokens=8)
        eng.update_params(w1, timeout=30)
        after = eng.generate([5, 17, 42], max_new_tokens=8)
        programs = eng.step_programs()
    finally:
        eng.stop()
    assert before == _run_generate(lm, [5, 17, 42], 8, None)
    assert after == generate(None, w1, [5, 17, 42], max_new_tokens=8,
                             buf_len=BUF, model=model)
    assert before != after
    names = [p[0] for p in programs]
    assert names == ["decode_step", "insert_cache"]
    with torch.no_grad():
        toks = programs[0][1](*programs[0][2])
    assert tuple(toks.shape) == (2, 1)


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_engine_mode_over_http(lm):
    """``OpenAICompatServer(batch_slots=..., adapters=...)``: completions
    route to the bank by ``model=``, equal ``generate`` with the adapter; a
    sampled top-k request falls through to the single-request path (same
    draws as ``generate``); an unknown adapter is a 404; adapters are added
    and evicted at run time."""
    model = lm["tmodel"]
    tok = lambda text: [256] + list(text.encode())
    srv = OpenAICompatServer(None, None, buf_len=BUF, model=model,
                             batch_slots=2, adapters={"a0": lm["tloras"]["a0"]},
                             kv_page_tokens=8)
    port = srv.start()
    try:
        code, body = _post(port, "/v1/completions",
                           {"prompt": "hi", "max_tokens": 6, "model": "a0"})
        assert code == 200
        want = generate(None, None, tok("hi"), max_new_tokens=6,
                        buf_len=BUF, model=model, eos_id=257,
                        lora=lm["tloras"]["a0"])
        assert body["choices"][0]["text"] == \
            bytes(i for i in want if i < 256).decode("utf-8", "replace")
        code, body = _post(port, "/v1/completions",
                           {"prompt": "hi", "max_tokens": 6,
                            "temperature": 0.7, "top_k": 5, "seed": 3})
        want = generate(None, None, tok("hi"), max_new_tokens=6, buf_len=BUF,
                        model=model, eos_id=257, temperature=0.7, top_k=5,
                        seed=3)
        assert code == 200 and body["choices"][0]["text"] == \
            bytes(i for i in want if i < 256).decode("utf-8", "replace")
        assert _post(port, "/v1/completions",
                     {"prompt": "x", "model": "nope"})[0] == 404
        srv.add_adapter("a1", lm["tloras"]["a1"])
        assert _post(port, "/v1/completions",
                     {"prompt": "x", "max_tokens": 2,
                      "adapter": "a1"})[0] == 200
        srv.evict_adapter("a1")
        assert _post(port, "/v1/completions",
                     {"prompt": "x", "adapter": "a1"})[0] == 404
    finally:
        srv.stop()
