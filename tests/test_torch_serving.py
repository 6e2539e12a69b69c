"""Serving's decode paths in the port against the JAX package's, on the CPU,
from the same weights (carried by ``llm/convert.py``) and numpy-seeded
inputs, at ``TINY`` widths in f32:

- decode logits and the cache after a prefill and 8 steps ≡ JAX
  ``model.apply(decode=True, mutable=["cache"])`` to 1e-5, for the native,
  int8 and paged caches (int8 codes equal except where a rounding tie
  flips, and then by one step); in bf16, the decode attention and its
  cache ≡ JAX's, with a control that a wrong cast point fails;
- the top-k/top-p kept set ≡ JAX's ``_sample_live`` on the same logits;
- greedy ``generate`` ≡ JAX ``generate`` token for token, with the eos stop,
  the prefix cache's exact and partial hits (the tail block and the
  per-token replay) and adapters; the plain full-buffer path ≡ the cached
  one;
- the server's HTTP responses carry the JAX server's JSON fields and text;
- every left-out option raises ``NotImplementedError`` by name.
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

from fedml_tpu.core import memory_estimate as j_mem
from fedml_tpu.llm import model as jm
from fedml_tpu.serving.templates import openai_compat as j_oc
from fedml_tpu_torch.core import memory_estimate as t_mem
from fedml_tpu_torch.llm import model as tm
from fedml_tpu_torch.llm.convert import (cache_from_flax, cache_to_flax,
                                         from_flax, lora_from_flax)
from fedml_tpu_torch.serving.templates import openai_compat as t_oc

LOGIT_TOL = 1e-5
BUF = 40
MAX_SEQ = 48


def _cfgs(**over):
    over = {"max_seq_len": MAX_SEQ, "attn_impl": "blockwise", **over}
    return (dataclasses.replace(jm.TINY, **over),
            dataclasses.replace(tm.TINY, **over))


def _saturated_lora(lora_zeros, seed):
    """A and B both non-zero: a zero B would make every adapter the base."""
    flat, treedef = jax.tree_util.tree_flatten(lora_zeros)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        (0.5 * rng.standard_normal(leaf.shape)).astype(np.float32)
        for leaf in flat])


@pytest.fixture(scope="module")
def lm():
    """TINY with LoRA rank 4 in both packages, from one set of weights, over
    the byte tokenizer's 258 ids."""
    jcfg, tcfg = _cfgs(lora_rank=4, vocab_size=258)
    jmodel = jm.LlamaLM(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8), jnp.int32))
    params_np = jax.tree_util.tree_map(np.asarray, variables["params"])
    tmodel, _ = from_flax(params_np, None, tcfg, device="cpu")
    loras = {f"a{i}": _saturated_lora(variables["lora"], 10 + i)
             for i in range(3)}
    zero = jax.tree_util.tree_map(np.zeros_like, variables["lora"])
    return dict(jmodel=jmodel, params=variables["params"], tmodel=tmodel,
                loras=loras, zero=zero)


def _tokens(rng, shape):
    return rng.integers(0, 256, shape).astype(np.int32)


#: a row whose int8 codes parted from JAX's at a rounding tie (one code one
#: step apart) is held to this instead of ``LOGIT_TOL``: one step of one
#: K or V entry moves the logits by ~1e-4 at these widths
INT8_TIE_TOL = 1e-3


def _row_codes(cache_np, row, tables):
    """The int8 K/V codes row ``row`` reads: its dense row, or its pages."""
    out = []
    for lay in sorted(cache_np):
        att = cache_np[lay]["attention"]
        for name in ("k", "v"):
            t = np.asarray(att[name])
            out.append(t[row] if tables is None else t[tables[row]])
    return np.concatenate([o.ravel() for o in out]).astype(np.int32)


def _check_step(jl, tl, jcache, tcache, kv, tables, tainted):
    """Logits to ``LOGIT_TOL`` on every row whose int8 codes still equal
    JAX's; a row whose codes parted at a tie (by one step at most) is marked
    and held to ``INT8_TIE_TOL``."""
    err = np.abs(np.asarray(jl) - tl.numpy()).max(axis=(1, 2))
    want = jax.tree_util.tree_map(np.asarray, jcache)
    got = cache_to_flax(tcache)
    for row in range(err.shape[0]):
        if kv == "int8":
            diff = np.abs(_row_codes(got, row, tables)
                          - _row_codes(want, row, tables))
            assert diff.max() <= 1, row       # a flipped rounding tie at most
            tainted[row] |= bool(diff.any())
        tol = INT8_TIE_TOL if tainted[row] else LOGIT_TOL
        assert err[row] < tol, (row, err[row], tainted)


@pytest.mark.parametrize("kv,paged", [("native", False), ("int8", False),
                                      ("native", True), ("int8", True)])
def test_decode_logits_and_cache_match_jax(kv, paged):
    """Prefill a batch of 2 over 16 tokens, then 8 single-token steps: each
    call's logits and the final cache ≡ the flax model's."""
    over = dict(kv_cache_dtype=kv)
    if paged:
        over.update(kv_page_tokens=8, kv_pool_pages=12)
    jcfg, tcfg = _cfgs(**over)
    jmodel = jm.LlamaLM(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel, _ = from_flax(jax.tree_util.tree_map(np.asarray, params), None,
                          tcfg, device="cpu")
    rng = np.random.default_rng(3)
    b = 2
    if paged:
        bt = np.array([[3, 1, 7, 6], [2, 5, 4, 9]], np.int32)
        jkw = {"block_tables": jnp.asarray(bt)}
        tkw = {"block_tables": torch.tensor(bt)}
        jstart = lambda p: jnp.full((b,), p, jnp.int32)
        tstart = lambda p: torch.full((b,), p)
    else:
        jkw, tkw = {}, {}
        jstart = lambda p: jnp.int32(p)
        tstart = lambda p: p

    @jax.jit
    def jprefill(tokens, start):
        return jmodel.apply({"params": params}, tokens, decode=True,
                            start_pos=start, mutable=["cache"], **jkw)

    @jax.jit
    def jstep(cache, tokens, start):
        return jmodel.apply({"params": params, "cache": cache}, tokens,
                            decode=True, start_pos=start, mutable=["cache"],
                            **jkw)

    prompt = _tokens(rng, (b, 16))
    jl, mut = jprefill(jnp.asarray(prompt), jstart(0))
    jcache = mut["cache"]
    cache = tmodel.init_cache(b, "cpu")
    tables = bt if paged else None
    tainted = [False] * b
    with torch.no_grad():
        tl = tmodel(torch.tensor(prompt), decode=True, start_pos=tstart(0),
                    cache=cache, **tkw)
        _check_step(jl, tl, jcache, cache, kv, tables, tainted)
        for step in range(8):
            tok = _tokens(rng, (b, 1))
            jl, mut = jstep(jcache, jnp.asarray(tok), jstart(16 + step))
            jcache = mut["cache"]
            tl = tmodel(torch.tensor(tok), decode=True,
                        start_pos=tstart(16 + step), cache=cache, **tkw)
            _check_step(jl, tl, jcache, cache, kv, tables, tainted)
    # every cache entry (the int8 scales too) against the flax cache
    want = jax.tree_util.tree_map(np.asarray, jcache)
    got = cache_to_flax(cache)
    for i in range(jcfg.n_layers):
        for key, w in want[f"layer_{i}"]["attention"].items():
            g = got[f"layer_{i}"]["attention"][key]
            if g.dtype == np.int8:
                assert np.abs(g.astype(np.int32) - w).max() <= 1
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                           err_msg=f"layer_{i}/{key}")
    # the JAX cache carried into the port continues as JAX does
    carried = cache_from_flax(want, device="cpu")
    tok = _tokens(rng, (b, 1))
    jl, mut = jstep(jcache, jnp.asarray(tok), jstart(24))
    with torch.no_grad():
        tl = tmodel(torch.tensor(tok), decode=True, start_pos=tstart(24),
                    cache=carried, **tkw)
    _check_step(jl, tl, mut["cache"], carried, kv, tables, [False] * b)


#: bf16 decode attention against JAX's on identical bf16 inputs: the mean,
#: over a prefill and 8 steps, of the output's relative error.  Both
#: packages round at the same points (K/V stored in bf16, f32 scores,
#: probabilities cast to bf16 before P·V, one cast of the product), so
#: most calls are bitwise equal (all 9 here), and a probability whose f32
#: sum lands on a bf16 rounding boundary moves one call by ~1.4e-3.  A
#: control that rounds the scores to bf16 (a wrong cast point) reads a mean
#: of 4.2e-3 to 4.4e-3.
#: Whole-model bf16 logits cannot hold the cast points: XLA's CPU
#: ``logistic`` in bf16 is off the correctly rounded value in ~29% of
#: elements (PyTorch's is correctly rounded), which alone moves TINY's
#: logits by ~4e-2 against the control's ~6e-2.
BF16_ATTN_TOL = 1e-3


def _bf16_attention_case(kv, paged):
    """Layer 0's attention of TINY in bf16 in both packages, from one set of
    weights: the inputs of a 16-token prefill and 8 steps, JAX's output of
    each call, and JAX's final cache."""
    over = dict(kv_cache_dtype=kv)
    if paged:
        over.update(kv_page_tokens=8, kv_pool_pages=12)
    jcfg, tcfg = _cfgs(**over)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    params = jax.jit(jm.LlamaLM(jcfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel, _ = from_flax(jax.tree_util.tree_map(np.asarray, params), None,
                          tcfg, device="cpu")
    jatt = jm.Attention(jcfg)
    b = 2
    bt = np.array([[3, 1, 7, 6], [2, 5, 4, 9]], np.int32) if paged else None

    @jax.jit
    def jcall(cache, x, positions):
        return jatt.apply({"params": params["layer_0"]["attention"],
                           **cache}, x, positions, decode=True,
                          block_tables=None if bt is None
                          else jnp.asarray(bt), mutable=["cache"])

    rng = np.random.default_rng(7)
    calls, cache = [], {}
    for start, s in [(0, 16)] + [(16 + i, 1) for i in range(8)]:
        x = rng.standard_normal((b, s, jcfg.dim)).astype(np.float32)
        pos = np.arange(s) + start
        jpos = np.broadcast_to(pos, (b, s)) if paged else pos
        out, mut = jcall(cache, jnp.asarray(x, jnp.bfloat16),
                         jnp.asarray(jpos))
        cache = {"cache": mut["cache"]}
        calls.append((start, x, np.asarray(out.astype(jnp.float32))))
    want = jax.tree_util.tree_map(np.asarray, cache["cache"])
    return tmodel, tcfg, bt, calls, want


def _bf16_attention_port(tmodel, tcfg, bt, calls):
    """The port's layer-0 decode attention over the same calls: each
    call's relative error against JAX's output, and the port's cache."""
    att = tmodel.layer_0.attention
    b = calls[0][1].shape[0]
    cache = tmodel.init_cache(b, "cpu")
    tables = None if bt is None else torch.tensor(bt)
    errs = []
    with torch.no_grad():
        for start, x, want in calls:
            s = x.shape[1]
            pos = torch.arange(s) + start
            st = start if bt is None else torch.full((b,), start)
            ctx = tm._DecodeCtx(pos if bt is None else pos[None].expand(b, s),
                                st, cache, tables, tcfg, b, s)
            got = att(torch.tensor(x).bfloat16(), pos, None,
                      cache.layers[0], ctx).float().numpy()
            errs.append(np.linalg.norm(got - want) / np.linalg.norm(want))
    return errs, cache


@pytest.mark.parametrize("kv,paged", [("native", False), ("int8", False),
                                      ("native", True), ("int8", True)])
def test_bf16_decode_attention_matches_jax(kv, paged, monkeypatch):
    """In bf16, each call's attention output ≡ JAX's to ``BF16_ATTN_TOL``
    (mean relative error) and the cache ≡ JAX's (bf16 K/V bitwise; int8
    codes within one step, scales to 1e-6); the same run with the scores
    rounded to bf16 is refused by that tolerance."""
    tmodel, tcfg, bt, calls, want = _bf16_attention_case(kv, paged)
    errs, cache = _bf16_attention_port(tmodel, tcfg, bt, calls)
    assert np.mean(errs) < BF16_ATTN_TOL, errs
    assert sum(e == 0 for e in errs) >= len(errs) // 2, errs
    got = cache_to_flax(tm.KVCache(cache.layers[:1]))["layer_0"]["attention"]
    for key, w in want.items():
        g = got[key]
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w).max() <= 1, key
        elif key.endswith("scale"):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)
        else:
            assert cache.layers[0][key].dtype == torch.bfloat16, key
            assert np.array_equal(g, np.asarray(w, np.float32)), key
    acc = tm._acc_f32
    monkeypatch.setattr(tm, "_acc_f32",
                        lambda a, b: acc(a, b).to(torch.bfloat16).float())
    control, _ = _bf16_attention_port(tmodel, tcfg, bt, calls)
    assert np.mean(control) > BF16_ATTN_TOL, control


def test_dense_write_clamps_like_dynamic_update_slice():
    """A write that would overrun the cache lands on its last positions
    (``lax.dynamic_update_slice`` clamps the start), for a scalar and a
    per-row start, while rope and the mask keep the unclamped positions."""
    jcfg, tcfg = _cfgs(max_seq_len=12)
    jmodel = jm.LlamaLM(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(2),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel, _ = from_flax(jax.tree_util.tree_map(np.asarray, params), None,
                          tcfg, device="cpu")
    rng = np.random.default_rng(5)
    prompt = _tokens(rng, (1, 10))
    over = _tokens(rng, (1, 4))          # positions 10..13 overrun 12
    apply = jax.jit(lambda v, t, start: jmodel.apply(
        v, t, decode=True, start_pos=start, mutable=["cache"]))
    jl, mut = apply({"params": params}, jnp.asarray(prompt), jnp.int32(0))
    jl, mut = apply({"params": params, "cache": mut["cache"]},
                    jnp.asarray(over), jnp.int32(10))
    for start in (10, torch.tensor([10])):
        cache = tmodel.init_cache(1, "cpu")
        with torch.no_grad():
            tmodel(torch.tensor(prompt), decode=True, start_pos=0,
                   cache=cache)
            tl = tmodel(torch.tensor(over), decode=True, start_pos=start,
                        cache=cache)
        assert np.abs(np.asarray(jl) - tl.numpy()).max() < LOGIT_TOL
        got = cache_to_flax(cache)["layer_1"]["attention"]["k"]
        want = np.asarray(mut["cache"]["layer_1"]["attention"]["k"])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("top_k,top_p", [(0, 0.9), (5, 1.0), (7, 0.5),
                                         (3, 1e-6), (0, 0.0)])
def test_top_k_top_p_kept_set_matches_jax(monkeypatch, top_k, top_p):
    """The filtered logits JAX hands to ``jax.random.categorical`` and the
    port's ``_filter`` keep the same tokens."""
    seen = []

    def capture(key, logits, *a, **k):
        seen.append(np.asarray(logits))
        return jnp.int32(0)

    monkeypatch.setattr(jax.random, "categorical", capture)
    rng = np.random.default_rng(11)
    for trial in range(4):
        live = rng.standard_normal(64).astype(np.float32) * 3
        if trial == 3:
            live[5] = live[9] = live.max()         # a tie at the top
        j_oc._sample_live(jnp.asarray(live), jax.random.PRNGKey(0),
                          jnp.float32(1.0), top_k, top_p)
        got = t_oc._filter(torch.tensor(live), top_k, top_p).numpy()
        np.testing.assert_array_equal(np.isfinite(got),
                                      np.isfinite(seen[-1]))
        assert np.isfinite(got).sum() >= 1
        # greedy picks the argmax whatever the filters
        assert int(t_oc._sample_live(torch.tensor(live), None, 0.0, top_k,
                                     top_p)) == int(np.argmax(live))


def _japply(jmodel):
    return lambda p, t: jmodel.apply({"params": p}, t)


def test_greedy_generate_matches_jax(lm):
    """Uncached, eos-stopped, adapter and prefix-cached generations ≡ the
    JAX package's, token for token."""
    jmodel, params, tmodel = lm["jmodel"], lm["params"], lm["tmodel"]
    rng = np.random.default_rng(7)
    prompts = [list(map(int, _tokens(rng, n))) for n in (3, 17, 30)]
    zero_j, zero_t = lm["zero"], lora_from_flax(lm["zero"], "cpu")
    for p in prompts:
        want = j_oc.generate(_japply(jmodel), params, p, max_new_tokens=12,
                             buf_len=BUF, model=jmodel, lora=zero_j)
        got = t_oc.generate(None, None, p, max_new_tokens=12, buf_len=BUF,
                            model=tmodel, lora=zero_t)
        assert got == want
        # lora=None is the base model too
        assert t_oc.generate(None, None, p, max_new_tokens=12, buf_len=BUF,
                             model=tmodel) == want
        # the eos stop: the third token as eos ends before it
        eos = want[2]
        cut = t_oc.generate(None, None, p, max_new_tokens=12, buf_len=BUF,
                            model=tmodel, eos_id=eos)
        assert cut == want[:want.index(eos)]
    # adapters: a saturated adapter changes the output, identically
    lora_j = lm["loras"]["a0"]
    want = j_oc.generate(_japply(jmodel), params, prompts[1],
                         max_new_tokens=12, buf_len=BUF, model=jmodel,
                         lora=lora_j)
    got = t_oc.generate(None, None, prompts[1], max_new_tokens=12,
                        buf_len=BUF, model=tmodel,
                        lora=lora_from_flax(lora_j, "cpu"))
    assert got == want
    # prefix cache: cold, exact hit, partial hit through the tail block
    # (tail 5), a tail longer than TAIL_BLOCK would miss, and the window's
    # end falls back to per-token replay
    jpc, tpc = j_oc.PrefixCache(8), t_oc.PrefixCache(8)
    base = prompts[2]
    seqs = [base, base, base[:25] + [1, 2, 3, 4, 5], base[:12],
            base + [9, 9, 9, 9, 9]]
    for p in seqs:
        want = j_oc.generate(_japply(jmodel), params, p, max_new_tokens=6,
                             buf_len=BUF, model=jmodel, lora=zero_j,
                             prefix_cache=jpc)
        got = t_oc.generate(None, None, p, max_new_tokens=6, buf_len=BUF,
                            model=tmodel, lora=zero_t, prefix_cache=tpc)
        assert got == want, p
    assert tpc.stats == jpc.stats
    assert tpc.stats["hits"] >= 3


def test_tail_replay_paths_match_uncached(lm):
    """The tail block (one forward) and the per-token replay at the
    window's end both give the uncached tokens."""
    tmodel = lm["tmodel"]
    rng = np.random.default_rng(8)
    p = list(map(int, _tokens(rng, 20)))
    pc = t_oc.PrefixCache(4, max_tail=64)
    t_oc.generate(None, None, p, max_new_tokens=2, buf_len=BUF,
                  model=tmodel, prefix_cache=pc)
    for q in (p + [3, 4, 5, 6], p + list(range(30, 48))):
        want = t_oc.generate(None, None, q, max_new_tokens=4, buf_len=BUF + 8,
                             model=tmodel)
        got = t_oc.generate(None, None, q, max_new_tokens=4, buf_len=BUF + 8,
                            model=tmodel, prefix_cache=pc)
        assert got == want
    assert pc.stats["hits"] == 2


def test_plain_full_buffer_path_matches_cached(lm):
    """``apply_fn`` re-run over the padded buffer ≡ the KV-cached decode,
    greedy and sampled (one generator draw per token on both paths)."""
    tmodel = lm["tmodel"]
    apply_fn = lambda params, tokens: tmodel(tokens)
    p = [5, 17, 42, 9]
    for temp in (0.0, 0.9):
        plain = t_oc.generate(apply_fn, None, p, max_new_tokens=10,
                              buf_len=BUF, temperature=temp, seed=3,
                              device="cpu")
        cached = t_oc.generate(None, None, p, max_new_tokens=10, buf_len=BUF,
                               model=tmodel, temperature=temp, seed=3)
        assert plain == cached


def test_params_dict_and_swap_invalidate_prefix_cache(lm):
    """``params`` as a weight dict is applied through ``functional_call``;
    a swapped dict drops the prefix cache's entries."""
    tmodel = lm["tmodel"]
    w0 = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    w1 = {n: p * 1.05 for n, p in w0.items()}
    p = [5, 17, 42, 9, 11]
    pc = t_oc.PrefixCache(4)
    a = t_oc.generate(None, w0, p, max_new_tokens=8, buf_len=BUF,
                      model=tmodel, prefix_cache=pc)
    assert a == t_oc.generate(None, None, p, max_new_tokens=8, buf_len=BUF,
                              model=tmodel)
    b = t_oc.generate(None, w1, p, max_new_tokens=8, buf_len=BUF,
                      model=tmodel, prefix_cache=pc)
    assert pc.stats["invalidations"] == 1
    assert b == t_oc.generate(None, w1, p, max_new_tokens=8, buf_len=BUF,
                              model=tmodel)


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def _shape(obj):
    """JSON structure without the values that differ per call."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return type(obj).__name__


def test_server_http_matches_jax_fields(lm):
    """Completions, chat and an SSE chat stream from both servers (dict
    adapters, no engine): the same JSON fields and the same text; models
    list, adapter routing by ``model=``, 404 for an unknown adapter."""
    jmodel, params, tmodel = lm["jmodel"], lm["params"], lm["tmodel"]
    jlora = {"a0": lm["loras"]["a0"]}
    tlora = {"a0": lora_from_flax(lm["loras"]["a0"], "cpu")}
    jsrv = j_oc.OpenAICompatServer(_japply(jmodel), params, buf_len=BUF,
                                   model=jmodel, adapters=jlora)
    tsrv = t_oc.OpenAICompatServer(None, None, buf_len=BUF, model=tmodel,
                                   adapters=tlora)
    jport, tport = jsrv.start(), tsrv.start()
    try:
        assert _get(tport, "/v1/models") == _get(jport, "/v1/models")
        calls = [("/v1/completions", {"prompt": "hi", "max_tokens": 8}),
                 ("/v1/completions", {"prompt": "hi", "max_tokens": 8,
                                      "model": "a0"}),
                 ("/v1/chat/completions",
                  {"messages": [{"role": "user", "content": "hey"}],
                   "max_tokens": 8})]
        for path, body in calls:
            js, jb = _post(jport, path, body)
            ts, tb = _post(tport, path, body)
            assert js == ts == 200
            jd, td = json.loads(jb), json.loads(tb)
            assert _shape(td) == _shape(jd)
            assert td["choices"] == jd["choices"]
            assert td["object"] == jd["object"]
        stream = {"messages": [{"role": "user", "content": "hey"}],
                  "max_tokens": 8, "stream": True}
        _, jb = _post(jport, "/v1/chat/completions", stream)
        _, tb = _post(tport, "/v1/chat/completions", stream)
        jl = [x for x in jb.split("\n\n") if x]
        tl = [x for x in tb.split("\n\n") if x]
        assert tl[-1] == jl[-1] == "data: [DONE]"
        pieces = lambda ls: "".join(
            json.loads(x[len("data: "):])["choices"][0]["delta"]["content"]
            for x in ls[:-1])
        assert pieces(tl) == pieces(jl)
        assert _shape(json.loads(tl[0][6:])) == _shape(json.loads(jl[0][6:]))
        js, _ = _post(jport, "/v1/completions", {"prompt": "x",
                                                 "adapter": "nope"})
        ts, _ = _post(tport, "/v1/completions", {"prompt": "x",
                                                 "adapter": "nope"})
        assert js == ts == 404
    finally:
        jsrv.stop()
        tsrv.stop()


LEFT_OUT = [
    ("export", lambda m: __import__(
        "fedml_tpu_torch.serving", fromlist=["x"]).save_model_artifact(
        "/nonexistent", m, None)),
    ("FedMLModelServingServer", lambda m: __import__(
        "fedml_tpu_torch.serving", fromlist=["x"]).FedMLModelServingServer()),
    ("FedMLModelServingClient", lambda m: __import__(
        "fedml_tpu_torch.serving", fromlist=["x"]).FedMLModelServingClient()),
]


@pytest.mark.parametrize("name,make", LEFT_OUT, ids=[n for n, _ in LEFT_OUT])
def test_left_out_options_raise_by_name(lm, name, make):
    with pytest.raises(NotImplementedError, match=name):
        make(lm["tmodel"])


def test_memory_estimates_match_jax():
    kw = dict(n_params=6.74e9, n_slots=8, cache_bytes=17.2e9,
              vocab_size=32000, horizon=4, param_bytes=2, bank_bytes=1e8)
    assert t_mem.estimate_serving_memory(**kw) == \
        j_mem.estimate_serving_memory(**kw)
    kw = dict(n_params=6.74e9, n_slots=8, pool_bytes=4.3e9,
              block_table_bytes=8 * 65 * 4, window_bytes=1e9,
              vocab_size=32000, horizon=2, param_bytes=2)
    assert t_mem.estimate_paged_serving_memory(**kw) == \
        j_mem.estimate_paged_serving_memory(**kw)


def test_tokenizer_and_inference_runner(tmp_path):
    """``load_tokenizer`` falls back to the byte tokenizer without local
    files; the predictor runner serves /predict and /ready."""
    from fedml_tpu_torch.llm.tokenization import load_tokenizer
    from fedml_tpu_torch.serving import FedMLInferenceRunner, FedMLPredictor
    tok = load_tokenizer(str(tmp_path / "missing"))
    assert isinstance(tok, t_oc.ByteTokenizer)
    assert tok.decode(tok.encode("héllo")) == "héllo"

    class Echo(FedMLPredictor):
        def predict(self, req):
            return {"n": len(req.get("xs", []))}

    runner = FedMLInferenceRunner(Echo(), port=0)
    port = runner.start()
    try:
        assert _get(port, "/ready") == {"ready": True}
        code, body = _post(port, "/predict", {"xs": [1, 2, 3]})
        assert code == 200 and json.loads(body) == {"result": {"n": 3}}
    finally:
        runner.stop()
