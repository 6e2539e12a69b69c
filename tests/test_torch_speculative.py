"""The port's speculative decode (``serving/speculative.py``, the
``SpeculativeBatchingEngine`` and the server's draft routing) against the
JAX package's, on the CPU, from the same weights (carried by
``llm/convert.py``), at ``tests/test_speculative.py``'s widths (dim 64, 2
layers, vocab 97; the draft dim 32, 1 layer) in f32:

- token ids equal JAX ``speculative_generate``'s and plain greedy's for an
  aligned draft (the target itself), a misaligned one (other weights) and
  an int8 draft of the target, with ``adaptive_k`` on and off; the stats
  (target and draft forwards, proposed, accepted) equal JAX's;
- the same at the buffer tail (verify-only rounds), with ``eos`` and with a
  LoRA adapter on the target (and the draft);
- the batched engine's tokens equal the port's plain engine and JAX's
  ``SpeculativeBatchingEngine``, stats included; a draft swap lands;
- one HTTP request through the server with a draft, batched and not;
- a paged target or draft, an overrunning ``max_seq_len`` and a sampled
  request are refused.
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.llm import model as jm
from fedml_tpu.llm.quantization import quantize_params_int8 as j_quant
from fedml_tpu.serving import batching as j_batching
from fedml_tpu.serving.speculative import speculative_generate as j_spec
from fedml_tpu.serving.templates.openai_compat import generate as j_generate
from fedml_tpu_torch.llm import model as tm
from fedml_tpu_torch.llm.convert import from_flax, lora_from_flax
from fedml_tpu_torch.llm.quantization import quantize_params_int8
from fedml_tpu_torch.serving import batching as t_batching
from fedml_tpu_torch.serving.speculative import speculative_generate
from fedml_tpu_torch.serving.templates import openai_compat as t_oc

BUF = 64


def _pair(seed, dim=64, layers=2, **over):
    """One JAX model and its port twin from the same weights."""
    kw = dict(vocab_size=97, dim=dim, n_layers=layers, n_heads=4,
              n_kv_heads=2, ffn_dim=dim * 2, max_seq_len=64,
              attn_impl="blockwise", **over)
    jcfg = jm.LlamaConfig(dtype=jnp.float32, **kw)
    tcfg = tm.LlamaConfig(dtype=torch.float32, **kw)
    jmodel = jm.LlamaLM(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tmodel, _ = from_flax(params, None, tcfg, device="cpu")
    return dict(j=jmodel, p=params, t=tmodel, v=variables)


@pytest.fixture(scope="module")
def models():
    target = _pair(0)
    draft = _pair(1, dim=32, layers=1)
    jq, _ = j_quant(target["p"])
    tq, _ = quantize_params_int8(target["t"])
    return dict(target=target, draft=draft, jq=jq, tq=tq)


def _drafts(m, kind):
    """(jax draft model, jax draft params, port draft, port draft params)."""
    t, d = m["target"], m["draft"]
    if kind == "aligned":
        return t["j"], t["p"], t["t"], None
    if kind == "misaligned":
        return d["j"], d["p"], d["t"], None
    return t["j"], m["jq"], t["t"], m["tq"]


STAT_KEYS = ("target_forwards", "draft_forwards", "proposed", "accepted")
PROMPTS = ([5, 17, 42], [7], list(range(1, 20)))


@pytest.mark.parametrize("kind", ["aligned", "misaligned", "int8"])
def test_speculative_matches_jax_and_greedy(models, kind):
    t = models["target"]
    jd, jdp, td, tdp = _drafts(models, kind)
    for prompt in PROMPTS:
        greedy = t_oc.generate(None, None, prompt, max_new_tokens=25,
                               buf_len=BUF, model=t["t"])
        assert greedy == j_generate(None, t["p"], prompt, max_new_tokens=25,
                                    buf_len=BUF, model=t["j"])
        for adaptive in (True, False):
            want, wst = j_spec(t["j"], t["p"], jd, jdp, prompt,
                               max_new_tokens=25, buf_len=BUF, k=4,
                               adaptive_k=adaptive)
            got, gst = speculative_generate(t["t"], None, td, tdp, prompt,
                                            max_new_tokens=25, buf_len=BUF,
                                            k=4, adaptive_k=adaptive)
            assert got == want == greedy, (prompt, adaptive)
            assert {k: gst[k] for k in STAT_KEYS} == \
                {k: wst[k] for k in STAT_KEYS}, (prompt, adaptive)
    if kind == "aligned":
        # every proposal accepted: ~k tokens per target forward
        assert gst["acceptance_rate"] == 1.0
        assert gst["target_forwards"] <= 25 // 4 + 2
    if kind == "misaligned":
        assert gst["acceptance_rate"] < 1.0


def test_buffer_tail_and_eos(models):
    """Decoding to the buffer's end (the padded sync would overrun: the
    loop falls back to verify-only rounds) and an eos mid-stream."""
    t, d = models["target"], models["draft"]
    prompt = list(range(1, 40))
    want, wst = j_spec(t["j"], t["p"], d["j"], d["p"], prompt,
                       max_new_tokens=40, buf_len=BUF, k=4)
    got, gst = speculative_generate(t["t"], None, d["t"], None, prompt,
                                    max_new_tokens=40, buf_len=BUF, k=4)
    assert got == want == t_oc.generate(None, None, prompt,
                                        max_new_tokens=40, buf_len=BUF,
                                        model=t["t"])
    assert len(got) == BUF - len(prompt)
    assert {k: gst[k] for k in STAT_KEYS} == {k: wst[k] for k in STAT_KEYS}
    base = t_oc.generate(None, None, [5, 17], max_new_tokens=20,
                         buf_len=BUF, model=t["t"])
    eos = base[5]
    got, _ = speculative_generate(t["t"], None, d["t"], None, [5, 17],
                                  max_new_tokens=20, buf_len=BUF, k=4,
                                  eos_id=eos)
    want, _ = j_spec(t["j"], t["p"], d["j"], d["p"], [5, 17],
                     max_new_tokens=20, buf_len=BUF, k=4, eos_id=eos)
    assert got == want == base[:base.index(eos)]


def test_lora_on_target_and_draft(models):
    """The target's adapter reaches prefill and verify: the output is
    ``generate(lora=...)``'s, not the base's; an adapted aligned draft
    accepts everything."""
    t = _pair(2, lora_rank=4)
    d = models["draft"]
    rng = np.random.default_rng(7)
    jlora = jax.tree_util.tree_map(
        lambda l: (0.5 * rng.standard_normal(l.shape)).astype(np.float32),
        t["v"]["lora"])
    tlora = lora_from_flax(jlora, device="cpu")
    prompt = [5, 17, 42]
    want, _ = j_spec(t["j"], t["p"], d["j"], d["p"], prompt,
                     max_new_tokens=16, buf_len=BUF, k=4, lora=jlora)
    got, _ = speculative_generate(t["t"], None, d["t"], None, prompt,
                                  max_new_tokens=16, buf_len=BUF, k=4,
                                  lora=tlora)
    assert got == want == t_oc.generate(None, None, prompt,
                                        max_new_tokens=16, buf_len=BUF,
                                        model=t["t"], lora=tlora)
    assert got != t_oc.generate(None, None, prompt, max_new_tokens=16,
                                buf_len=BUF, model=t["t"],
                                lora={k: torch.zeros_like(v)
                                      for k, v in tlora.items()})
    got, st = speculative_generate(t["t"], None, t["t"], None, prompt,
                                   max_new_tokens=16, buf_len=BUF, k=4,
                                   adaptive_k=False, lora=tlora,
                                   draft_lora=tlora)
    assert got == want and st["acceptance_rate"] == 1.0


def _engine_pair(k=3, buf=32):
    """``tests/test_serving_plane.py``'s speculative engine config."""
    kw = dict(vocab_size=97, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
              ffn_dim=64, max_seq_len=buf + k + 1, attn_impl="blockwise")
    dkw = dict(kw, dim=16, n_layers=1, n_heads=2, ffn_dim=32)
    out = []
    for seed, c in ((0, kw), (1, dkw)):
        jmodel = jm.LlamaLM(jm.LlamaConfig(dtype=jnp.float32, **c))
        p = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
            jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
            ["params"])
        tmodel, _ = from_flax(p, None, tm.LlamaConfig(dtype=torch.float32,
                                                      **c), device="cpu")
        out.append((jmodel, p, tmodel))
    return out


def _drain(q):
    got = []
    while (t := q.get(timeout=120)) is not None:
        got.append(t)
    return got


def test_batching_engine_matches_plain_engine_and_jax():
    k, buf = 3, 32
    (jt, jp, tt), (jd, jdp, td) = _engine_pair(k, buf)
    prompts = [[5, 17, 42], [7, 7], [1, 2, 3, 4], [60]]
    budgets = [10, 3, 13, 6]
    ref0 = t_oc.generate(None, None, prompts[0], max_new_tokens=10,
                         buf_len=buf, model=tt)
    eoss = [ref0[4], None, None, None]

    def run(eng):
        try:
            qs = [eng.submit(p, max_new_tokens=b, eos_id=e)
                  for p, b, e in zip(prompts, budgets, eoss)]
            return [_drain(q) for q in qs], dict(eng.stats)
        finally:
            eng.stop()

    plain = t_batching.ContinuousBatchingEngine(tt, None, slots=2,
                                                buf_len=buf)
    try:
        want = [plain.generate(p, max_new_tokens=b, eos_id=e)
                for p, b, e in zip(prompts, budgets, eoss)]
    finally:
        plain.stop()
    jout, jst = run(j_batching.SpeculativeBatchingEngine(
        jt, jp, jd, jdp, slots=2, buf_len=buf, k=k))
    teng = t_batching.SpeculativeBatchingEngine(tt, None, td, None, slots=2,
                                                buf_len=buf, k=k)
    with pytest.raises(ValueError, match="greedy-only"):
        teng.submit([1, 2], temperature=0.7)
    tout, tst = run(teng)
    assert tout == want == jout
    assert tst == jst
    assert 0 < tst["accepted"] < tst["proposed"]

    # an aligned draft: everything accepted, k+1 tokens a block forward
    eng = t_batching.SpeculativeBatchingEngine(tt, None, tt, None, slots=1,
                                               buf_len=buf, k=k)
    try:
        out = eng.generate([5, 17, 42], max_new_tokens=12)
        assert out == t_oc.generate(None, None, [5, 17, 42],
                                    max_new_tokens=12, buf_len=buf,
                                    model=tt)
        assert eng.stats["accepted"] == eng.stats["proposed"]
        assert eng.stats["target_block_forwards"] <= -(-11 // (k + 1)) + 1
        s = eng._slots[0]
        assert s.drafts_accepted == s.drafts_proposed > 0
        # a draft swap lands after the drain: the misaligned draft's params
        # on the aligned module lower acceptance, never the output
        before = dict(eng.stats)
        noisy = {n: p + 0.05 * torch.randn(p.shape, generator=torch
                                           .Generator().manual_seed(0))
                 for n, p in tt.named_parameters()}
        eng.update_params(None, draft_params=noisy)
        assert eng.raw_draft is noisy
        assert eng.generate([5, 17, 42], max_new_tokens=12) == out
        assert eng.stats["proposed"] > before["proposed"]
    finally:
        eng.stop()


def test_server_routes_greedy_requests_through_the_draft(models):
    t, d = models["target"], models["draft"]
    tok = t_oc.ByteTokenizer()
    prompt = "hi"
    ids = [i % 97 for i in tok.encode(prompt)]
    want = j_generate(None, t["p"], ids, max_new_tokens=6, buf_len=BUF,
                      model=t["j"])

    class Tok(t_oc.ByteTokenizer):
        """Byte ids folded into the 97-token vocabulary."""
        eos_id = None

        def encode(self, text, add_bos=True):
            return [i % 97 for i in super().encode(text, add_bos)]

    for batch in (0, 2):
        buf = BUF - 5 if batch else BUF   # the engine needs buf+k+1 <= 64
        srv = t_oc.OpenAICompatServer(
            None, None, model=t["t"], draft_model=d["t"], draft_params=None,
            batch_slots=batch, buf_len=buf, spec_k=4, tokenizer=Tok())
        port = srv.start()
        try:
            assert (srv._engine is not None) == bool(batch)
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/completions",
                data=json.dumps({"prompt": prompt,
                                 "max_tokens": 6}).encode(),
                headers={"Content-Type": "application/json"})
            body = json.loads(urllib.request.urlopen(req, timeout=60).read())
            assert body["choices"][0]["text"] == tok.decode(want)
            if batch:
                assert srv._engine.stats["target_block_forwards"] > 0
        finally:
            srv.stop()


def test_paged_overrun_and_draft_refusals(models):
    t, d = models["target"], models["draft"]
    pcfg = dataclasses.replace(t["t"].cfg, kv_page_tokens=8,
                               kv_pool_pages=16)
    ptarget = tm.LlamaLM(pcfg)
    for args in ((ptarget, None, d["t"], None), (t["t"], None, ptarget,
                                                 None)):
        with pytest.raises(t_batching.PagedKVUnsupportedError):
            t_batching.SpeculativeBatchingEngine(*args, slots=1, buf_len=32)
    with pytest.raises(ValueError, match="max_seq_len"):
        t_batching.SpeculativeBatchingEngine(t["t"], None, d["t"], None,
                                             slots=1, buf_len=BUF)
    with pytest.raises(t_batching.PagedKVUnsupportedError):
        t_oc.OpenAICompatServer(None, None, model=t["t"], draft_model=d["t"],
                                batch_slots=2, kv_page_tokens=8, buf_len=32)
    with pytest.raises(ValueError, match="decode_horizon"):
        t_oc.OpenAICompatServer(None, None, model=t["t"], draft_model=d["t"],
                                batch_slots=2, decode_horizon=2, buf_len=32)
    with pytest.raises(ValueError, match="requires `model`"):
        t_oc.OpenAICompatServer(None, None, draft_model=d["t"])
