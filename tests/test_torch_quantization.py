"""The port's int8 weight-only trees (``llm/quantization.py``) against the
JAX package's, on the CPU, from the same weights (carried by
``llm/convert.py``) at ``TINY`` widths in f32:

- codes and scales bitwise JAX's, and the JAX tree carried across by
  ``quantized_from_flax`` bitwise the port's own quantization;
- the dequantized weights bitwise JAX's in f32 and bf16, and the
  one-pass dequantize bitwise the two-step ``(q.float() * s).to(dtype)``;
- ``quantization_error`` within 1e-6;
- the quantized tree's logits (plain and decode forwards) within the decode
  parity's 1e-5 of JAX's ``make_quantized_apply``;
- a quantized tree through ``generate``, the batching engine (and its
  ``update_params``) and the server gives the JAX greedy token ids;
- anything but a float dict or a ``QuantizedParams`` is refused by name.
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
from fedml_tpu.llm import quantization as jq
from fedml_tpu.serving.templates import openai_compat as j_oc
from fedml_tpu_torch.llm import model as tm
from fedml_tpu_torch.llm import quantization as tq
from fedml_tpu_torch.llm.convert import from_flax, quantized_from_flax
from fedml_tpu_torch.serving.batching import ContinuousBatchingEngine
from fedml_tpu_torch.serving.templates import openai_compat as t_oc

LOGIT_TOL = 1e-5
BUF = 40


@pytest.fixture(scope="module")
def lm():
    over = dict(max_seq_len=48, attn_impl="blockwise", vocab_size=258)
    jcfg = dataclasses.replace(jm.TINY, **over)
    tcfg = dataclasses.replace(tm.TINY, **over)
    jmodel = jm.LlamaLM(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    params_np = jax.tree_util.tree_map(np.asarray, params)
    tmodel, _ = from_flax(params_np, None, tcfg, device="cpu")
    jq_tree, jstats = jq.quantize_params_int8(params_np)
    tq_tree, tstats = tq.quantize_params_int8(tmodel)
    return dict(jmodel=jmodel, params=params, params_np=params_np,
                tmodel=tmodel, jq=jq_tree, jstats=jstats, tq=tq_tree,
                tstats=tstats)


def _flat_q(jtree):
    """``{port name: (codes, scale)}`` of a JAX quantized tree."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict) and "__q8__" in node:
            out[path] = (np.asarray(node["q"]), np.asarray(node["scale"]))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)

    walk(jtree, "")
    return out


def test_codes_and_scales_are_bitwise_jax(lm):
    want = _flat_q(lm["jq"])
    got = lm["tq"].pairs()
    assert set(got) == set(want) and len(got) >= 8
    assert "tok_embed.embedding" in got and "lm_head.kernel" in got
    for name, (q, s) in got.items():
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), want[name][0], err_msg=name)
        np.testing.assert_array_equal(s.numpy(), want[name][1], err_msg=name)
    # the norm scales stay full precision under their own names
    assert set(lm["tq"].plain()) == {n for n, p in lm["tmodel"]
                                     .named_parameters() if p.dim() < 2}
    assert lm["tstats"] == lm["jstats"]
    carried = quantized_from_flax(lm["jq"], device="cpu")
    assert set(carried) == set(lm["tq"])
    for k, v in carried.items():
        assert torch.equal(v, lm["tq"][k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantized_weights_are_bitwise_jax(lm, dtype):
    jd = jq.dequantize_params(lm["jq"], getattr(jnp, dtype))
    td = tq.dequantize_params(lm["tq"], getattr(torch, dtype))
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        else:
            flat[path] = np.asarray(jnp.asarray(node, jnp.float32))

    walk(jd, "")
    assert set(flat) == set(td)
    for name, t in td.items():
        np.testing.assert_array_equal(t.float().numpy(), flat[name],
                                      err_msg=name)
    for name, (q, s) in lm["tq"].pairs().items():
        two_step = (q.float() * s).to(getattr(torch, dtype))
        assert torch.equal(td[name], two_step), name


def test_quantization_error_matches_jax(lm):
    want = jq.quantization_error(lm["params_np"], lm["jq"])
    got = tq.quantization_error(lm["tmodel"], lm["tq"])
    for k in ("max_rel_err", "mean_rel_err"):
        assert abs(got[k] - want[k]) < 1e-6, (k, got[k], want[k])
    assert 0 < got["max_rel_err"] < 0.02


def test_quantized_logits_match_jax(lm):
    """The plain forward and a decode prefill + step under the quantized
    tree (each weight dequantized at its product, the embedding gathered
    first) within 1e-5 of JAX's quantized apply."""
    toks = np.random.default_rng(0).integers(0, 256, (2, 12)).astype(
        np.int32)
    jl = jq.make_quantized_apply(lm["jmodel"])(lm["jq"], jnp.asarray(toks))
    tl = tq.make_quantized_apply(lm["tmodel"])(lm["tq"],
                                               torch.from_numpy(toks).long())
    assert np.abs(np.asarray(jl) - tl.numpy()).max() < LOGIT_TOL
    # not the dense weights' logits: the quantization moved them
    dense = lm["tmodel"](torch.from_numpy(toks).long())
    assert (dense - tl).abs().max() > 1e-4

    jp = jq.dequantize_params(lm["jq"], jnp.float32)
    jlog, mut = lm["jmodel"].apply({"params": jp}, jnp.asarray(toks),
                                   decode=True, start_pos=0,
                                   mutable=["cache"])
    jstep, _ = lm["jmodel"].apply({"params": jp, **mut},
                                  jnp.asarray(toks[:, :1]), decode=True,
                                  start_pos=12, mutable=["cache"])
    cache = lm["tmodel"].init_cache(2, "cpu")
    with torch.no_grad():
        tlog = t_oc._apply(lm["tmodel"], lm["tq"],
                           torch.from_numpy(toks).long(), None, decode=True,
                           start_pos=0, cache=cache)
        tstep = t_oc._apply(lm["tmodel"], lm["tq"],
                            torch.from_numpy(toks[:, :1]).long(), None,
                            decode=True, start_pos=12, cache=cache)
    assert np.abs(np.asarray(jlog) - tlog.numpy()).max() < LOGIT_TOL
    assert np.abs(np.asarray(jstep) - tstep.numpy()).max() < LOGIT_TOL


PROMPTS = ([5, 17, 42, 9], [1], list(range(30, 52)))


def test_quantized_tree_through_generate_and_engine(lm):
    want = [j_oc.generate(None, lm["jq"], p, max_new_tokens=10,
                          buf_len=BUF, model=lm["jmodel"]) for p in PROMPTS]
    got = [t_oc.generate(None, lm["tq"], p, max_new_tokens=10, buf_len=BUF,
                         model=lm["tmodel"]) for p in PROMPTS]
    assert got == want
    dense = [t_oc.generate(None, None, p, max_new_tokens=10, buf_len=BUF,
                           model=lm["tmodel"]) for p in PROMPTS]
    eng = ContinuousBatchingEngine(lm["tmodel"], None, slots=2, buf_len=BUF)
    try:
        assert [eng.generate(p, max_new_tokens=10) for p in PROMPTS] == dense
        eng.update_params(lm["tq"])
        qs = [eng.submit(p, max_new_tokens=10) for p in PROMPTS]
        outs = []
        for q in qs:
            toks = []
            while (t := q.get(timeout=60)) is not None:
                toks.append(t)
            outs.append(toks)
        assert outs == want
    finally:
        eng.stop()


def test_server_serves_a_quantized_tree(lm):
    prompt = "hi"
    tok = t_oc.ByteTokenizer()
    want = j_oc.generate(None, lm["jq"], tok.encode(prompt),
                         max_new_tokens=6, buf_len=BUF, model=lm["jmodel"],
                         eos_id=tok.eos_id)
    srv = t_oc.OpenAICompatServer(None, lm["tq"], model=lm["tmodel"],
                                  buf_len=BUF, batch_slots=2)
    port = srv.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions",
            data=json.dumps({"prompt": prompt, "max_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        body = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert body["choices"][0]["text"] == tok.decode(want)
    finally:
        srv.stop()


def test_non_float_leaves_outside_a_quantized_tree_are_refused(lm):
    bad = {"lm_head.kernel": torch.zeros((2, 2), dtype=torch.int8)}
    with pytest.raises(TypeError, match="QuantizedParams"):
        t_oc.generate(None, bad, [1, 2], model=lm["tmodel"])
    broken = tq.QuantizedParams(lm["tq"])
    del broken["lm_head.kernel" + tq.Q8 + ".scale"]
    with pytest.raises(ValueError, match="lm_head"):
        t_oc.generate(None, broken, [1, 2], model=lm["tmodel"])
