"""The port's quantized collectives, flat model view and LoRA mesh regime
against the JAX package, on the CPU.

- ``core/compression/blockscale.py`` and ``core/flatmodel.py``: bitwise
  the JAX package's, given the same rounding noise; the numpy twins
  bitwise the originals; the wire-size model equal.
- ``collective_precision`` bf16 / int8 with error feedback, on the sp
  engine and on the mesh (2 gloo ranks, both merge layouts), against the
  JAX engines with the JAX package's own threefry noise passed in through
  the ``quant_noise`` hook.  The quantizer is bitwise the same, but its
  input differs between the packages by f32 summation order, and where a
  value sits within that difference of a rounding boundary the two
  round it to neighbouring levels.  So the limits are: losses within
  1e-5; every element of the params, the fp32 master and the EF rows
  within 2e-5 but at most 0.5% of them, and those within two
  quantization steps (bf16: 2^-6 of the value; int8: 2/127 of the
  largest magnitude).  FedOpt's server Adam turns a one-step difference
  into a step of ``server_lr``'s order, so there (as the JAX package's
  own quantized test does) the loss curve is the contract, with the same
  0.5% count.
- ``FedLLMAPI(mesh=...)`` on 2 ranks with a cohort of 3 (one pad row)
  against the single-device round from the same adapters: 1e-6 (each
  client's local steps are the same computation; only the merge's sums
  are ordered differently).
- the card index a rank takes inside a process group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core import rng as j_rng
from fedml_tpu.core.compression import blockscale as J
from fedml_tpu.core.flatmodel import FlatSpec as JFlatSpec
from fedml_tpu.core.state import resolve_collective_precision as j_resolve
from fedml_tpu.simulation.round_engine import QUANT_KEY_TAG
from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvg

from fedml_tpu_torch import device as t_device
from fedml_tpu_torch.arguments import load_arguments as t_arguments
from fedml_tpu_torch.core.compression import blockscale as T
from fedml_tpu_torch.core.flatmodel import FlatSpec
from fedml_tpu_torch.core.state import resolve_collective_precision
from fedml_tpu_torch.simulation.mesh.launch import spawn
from fedml_tpu_torch.simulation.round_engine import QUANT_KEY_TAG as T_TAG
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI as TFedAvg

from .torch_mesh_parity import (SPAWN_TIMEOUT, jax_api, jax_mesh, mesh_cfg,
                                port_model, to_port)
from .torch_mesh_ranks import _build

BLOCK = 256
ROUNDS = 4


# -- the quantizer, bitwise -------------------------------------------------

def _vec(n=1000, seed=0):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32) * 3


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("block", [64, 256])
def test_blockscale_matches_jax_given_the_noise(precision, block):
    x = _vec()
    key = jax.random.PRNGKey(5)
    if precision == "bf16":
        noise = np.asarray(jax.random.randint(key, x.shape, 0, 1 << 16,
                                              dtype=jnp.uint32), np.int64)
    else:
        noise = np.asarray(jax.random.uniform(key, (-(-1000 // block),
                                                    block)))
    jd, je = J.collective_quantize(jnp.asarray(x), precision, key, block)
    td, te = T.collective_quantize(torch.tensor(x), precision,
                                   torch.tensor(noise), block)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the residual energy is a sum: equal up to its order
    np.testing.assert_allclose(float(te), float(je), rtol=1e-6)
    # round-to-nearest, and the broadcast with its residual
    jd, _ = J.collective_quantize(jnp.asarray(x), precision, None, block)
    td, _ = T.collective_quantize(torch.tensor(x), precision, None, block)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    ef = _vec(seed=1) * 1e-3
    js, jef, _ = J.quantize_broadcast(jnp.asarray(x), jnp.asarray(ef),
                                      precision, key, block)
    ts, tef, _ = T.quantize_broadcast(torch.tensor(x), torch.tensor(ef),
                                      precision, torch.tensor(noise), block)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tef.numpy(), np.asarray(jef))
    # a generator draws noise of the right kind and shape
    g = torch.Generator().manual_seed(0)
    q, s = T.blockscale_quantize(torch.tensor(x), block=block, noise=g)
    assert q.dtype == torch.int8 and q.shape == (-(-1000 // block), block)


def test_numpy_twins_are_the_jax_package_s():
    x = _vec(777)
    for bits, block in ((8, 256), (8, 64), (16, 128)):
        jq, js = J.blockscale_quantize_np(x, bits=bits, block=block)
        tq, ts = T.blockscale_quantize_np(x, bits=bits, block=block)
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(ts, js)
        assert tq.dtype == jq.dtype
        np.testing.assert_array_equal(
            T.blockscale_dequantize_np(tq, ts, 777),
            J.blockscale_dequantize_np(jq, js, 777))
    h = T.bf16_round_np(x)
    np.testing.assert_array_equal(h, J.bf16_round_np(x))
    np.testing.assert_array_equal(T.bf16_expand_np(h), J.bf16_expand_np(h))
    # the f32 -> bf16 twin is torch's round-to-nearest-even too
    np.testing.assert_array_equal(
        T.bf16_expand_np(h),
        torch.tensor(x).to(torch.bfloat16).float().numpy())


def test_wire_size_model_is_the_jax_package_s():
    for n in (1, 255, 256, 7850, 100_003):
        for prec in T.COLLECTIVE_PRECISIONS:
            assert T.collective_payload_nbytes(n, prec, 64) == \
                J.collective_payload_nbytes(n, prec, 64)
            for shards in (1, 2, 4):
                for mode in ("scatter", "replicated"):
                    assert T.modeled_collective_bytes(
                        n, shards, prec, 256, mode) == \
                        J.modeled_collective_bytes(n, shards, prec, 256,
                                                   mode)
    with pytest.raises(ValueError, match="precision"):
        T.collective_quantize(torch.zeros(3), "fp8")


def test_resolve_collective_precision_is_the_jax_package_s():
    assert T_TAG == QUANT_KEY_TAG
    for value in ("fp32", "bf16", "int8", "auto", None):
        for shards in (1, 8):
            args = t_arguments().update(collective_precision=value)
            assert resolve_collective_precision(args, shards) == \
                j_resolve(args, shards)
    with pytest.raises(ValueError, match="collective_precision"):
        resolve_collective_precision(
            t_arguments().update(collective_precision="fp16"), 8)


@pytest.mark.parametrize("model", ["lr", "cnn_web", "text_transformer"])
def test_flat_spec_is_the_jax_package_s(model):
    """The port's flat view of its params, in the model's flax layout, is
    bitwise the JAX ``FlatSpec`` of the same weights: padded length,
    chunks, and the inverse."""
    over = dict(model=model, data_cache_dir="")
    if model == "text_transformer":
        over.update(dataset="20news", seq_len=16, vocab_size=50,
                    model_dim=16, model_layers=1, model_heads=2,
                    model_ffn_dim=32)
    else:
        over.update(input_shape=(12, 12, 1))
    cfg = mesh_cfg(**over)
    japi = jax_api(JFedAvg, cfg)
    jp = japi.state.global_params
    tmodel = port_model(cfg)
    tp = {k: torch.as_tensor(v) for k, v in to_port(jp, tmodel).items()}
    for multiple in (1, 4, 8):
        jspec = JFlatSpec.of(jp, multiple)
        spec = FlatSpec.of(tp, multiple, tmodel.flat_layout())
        assert (spec.n_params, spec.padded_size, spec.chunk_size) == \
            (jspec.n_params, jspec.padded_size, jspec.chunk_size)
        vec = spec.flatten(tp)
        np.testing.assert_array_equal(vec.numpy(),
                                      np.asarray(jspec.flatten(jp)))
        np.testing.assert_array_equal(
            spec.chunk(vec, multiple - 1, multiple).numpy(),
            np.asarray(jspec.chunk(jspec.flatten(jp), multiple - 1,
                                   multiple)))
        back = spec.unflatten(vec)
        for k, v in tp.items():
            assert torch.equal(back[k], v), k


# -- quantized rounds against the JAX engines --------------------------------

def jax_noise(seed, precision, slots, shards=(None,)):
    """The JAX package's rounding noise of ``ROUNDS`` rounds, keyed as the
    ``quant_noise`` hook asks for it: ``(round, shard, slot)``.  The sp
    engine folds the slot into the round's quantization key, the mesh
    folds the shard first (``shard_qkeys``/``slot_key``).  ``slots``:
    ``(slot, payload length)`` pairs."""
    out = {}
    for r in range(ROUNDS):
        q = jax.random.fold_in(j_rng.round_key(j_rng.root_key(seed), r),
                               QUANT_KEY_TAG)
        for sh in shards:
            base = q if sh is None else jax.random.fold_in(q, sh)
            for slot, n in slots:
                k = jax.random.fold_in(base, slot)
                if precision == "bf16":
                    out[(r, sh, slot)] = np.asarray(jax.random.randint(
                        k, (n,), 0, 1 << 16, dtype=jnp.uint32), np.int64)
                else:
                    out[(r, sh, slot)] = np.asarray(jax.random.uniform(
                        k, (-(-n // BLOCK), BLOCK)))
    return out


def quant_close(got, want, precision, what, steps_ok=True):
    """See the module docstring for the limits."""
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    diff = np.abs(got - want)
    off = diff > 2e-5
    assert off.sum() <= 0.005 * got.size, (what, int(off.sum()), got.size)
    if steps_ok:
        if precision == "bf16":
            bound = 2.0 ** -6 * np.abs(want) + 2e-5
        else:
            bound = np.full_like(want, 2.0 * np.abs(want).max() / 127 + 2e-5)
        assert (diff <= bound).all(), (what, float(diff.max()))


def _close_run(res, japi, model, precision, alg, what):
    np.testing.assert_allclose(res["losses"], res["jlosses"], atol=1e-5,
                               rtol=0, err_msg=what)
    steps_ok = alg != "FedOpt"
    ref = to_port(japi.state.global_params, model)
    quant_close(np.concatenate([np.ravel(res["params"][k]) for k in ref]),
                np.concatenate([np.ravel(ref[k]) for k in ref]), precision,
                f"{what} params", steps_ok)
    for f in ("master_flat", "ef_num", "ef_bcast"):
        jv = getattr(japi.state, f)
        assert (jv is None) == (res[f] is None), (what, f)
        if jv is not None:
            # a residual moves by the step it rounded by: the count only
            quant_close(res[f], np.asarray(jv), precision, f"{what} {f}",
                        steps_ok and f == "master_flat")


QUANT_ALGS = ["FedAvg", "SCAFFOLD", "FedOpt"]


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("alg", QUANT_ALGS)
def test_sp_quantized_rounds_match_jax(alg, precision):
    """The port's sp engine with the quantized merge and broadcast (the
    JAX ``test_quantized_parity`` configs) against the JAX sp engine, the
    JAX noise passed in."""
    cfg = mesh_cfg(federated_optimizer=alg, collective_precision=precision,
                   partition_method="homo")
    model = port_model(cfg)
    japi = jax_api(JFedAvg, cfg)
    init = to_port(japi.state.global_params, model)
    n = sum(v.size for v in init.values())
    noise = jax_noise(7, precision, [(0, n)]
                      + ([(1, n)] if precision == "int8" else []))
    tapi = _build(TFedAvg, cfg)
    assert tapi.collective_precision == precision
    tapi.reset_params({k: torch.as_tensor(v) for k, v in init.items()})
    tapi.quant_noise = lambda r, sh, slot, kind, shape: noise[(r, sh, slot)]
    res = {"jlosses": [float(japi.train_one_round(r)["train_loss"])
                       for r in range(ROUNDS)],
           "losses": [float(tapi.train_one_round(r)["train_loss"])
                      for r in range(ROUNDS)]}
    st = tapi.state
    res.update(params={k: v.numpy() for k, v in st.global_params.items()},
               master_flat=st.master_flat.numpy(), ef_num=st.ef_num.numpy(),
               ef_bcast=None if st.ef_bcast is None else st.ef_bcast.numpy())
    _close_run(res, japi, model, precision, alg, f"sp {alg}")
    # the clients trained from the quantized broadcast copy
    if precision == "bf16":
        for v in st.global_params.values():
            assert torch.equal(v, v.to(torch.bfloat16).float())


MESH_QUANT = [(alg, lay, prec) for alg in ("FedAvg", "SCAFFOLD")
              for lay in ("replicated", "scatter")
              for prec in ("bf16", "int8")]
_MESH = {}


def _mesh_runs():
    if _MESH:
        return _MESH
    jobs = []
    for alg, lay, prec in MESH_QUANT:
        cfg = mesh_cfg(federated_optimizer=alg, update_sharding=lay,
                       collective_precision=prec, partition_method="homo")
        model = port_model(cfg)
        japi, init, ms = jax_mesh(cfg, 2, ROUNDS)
        init = to_port(init, model)
        n = sum(v.size for v in init.values())
        n = -(-n // 2) * 2 if lay == "scatter" else n
        slots = [(0, n)] + ([(1, n // 2)] if lay == "scatter"
                            and prec == "int8" else [])
        jobs.append((cfg, ROUNDS, init, jax_noise(7, prec, slots, (0, 1))))
        _MESH[(alg, lay, prec)] = dict(japi=japi, jms=ms, model=model)
    res = spawn("tests.torch_mesh_ranks:mesh_cases", 2, (jobs,),
                timeout=SPAWN_TIMEOUT)[0]
    for key, r in zip(MESH_QUANT, res):
        _MESH[key]["port"] = r
    return _MESH


@pytest.mark.parametrize("alg,layout,precision", MESH_QUANT)
def test_mesh_quantized_rounds_match_jax_mesh(alg, layout, precision):
    """2 ranks against the JAX mesh on 2 devices: the EF-quantized
    numerator (all-reduced or reduce-scattered at the wire precision) and
    in the scatter layout the quantized broadcast from the shard-resident
    master, each shard's noise its own."""
    run = _mesh_runs()[(alg, layout, precision)]
    res, japi = run["port"], run["japi"]
    st = res["state"]
    assert res["precision"] == precision and res["layout"] == layout
    assert res["steps"] == [m[1] for m in run["jms"]]
    flat = dict(jlosses=[m[0] for m in run["jms"]], losses=res["losses"],
                params=st["global_params"], master_flat=st["master_flat"],
                ef_num=st["ef_num"], ef_bcast=st["ef_bcast"])
    _close_run(flat, japi, run["model"], precision, alg,
               f"mesh {alg}/{layout}")


def test_quantized_layer_refusals():
    """Bucketing refuses it (as the JAX package does); a population,
    ``round_block`` and the engines with round loops of their own refuse
    it by name; a spec without the params average cannot quantize it."""
    cfg = mesh_cfg(collective_precision="int8")
    with pytest.raises(ValueError, match="collective_precision"):
        _build(TFedAvg, dict(cfg, cohort_bucketing=True))
    from fedml_tpu_torch.simulation.sp.hierarchical_fl import \
        HierarchicalFedAvgAPI
    for cls, over in ((TFedAvg, dict(round_block=2)),
                      (TFedAvg, dict(population=2)),
                      (HierarchicalFedAvgAPI, {})):
        with pytest.raises(NotImplementedError,
                           match="collective_precision"):
            _build(cls, dict(cfg, **over))
    with pytest.raises(ValueError, match="avg_params"):
        _build(TFedAvg, dict(cfg, federated_optimizer="qFedAvg"))


# -- FedLLMAPI(mesh=...) ----------------------------------------------------

def _llm_cfg():
    """``tests/test_torch_fedllm.py``'s config with heterogeneous adapter
    ranks: 3 clients a round."""
    return dict(model="tiny_llama", dataset="shakespeare", seq_len=32,
                client_num_in_total=6, client_num_per_round=3, comm_round=2,
                batch_size=4, learning_rate=1e-3, random_seed=9,
                llm_max_local_steps=4, lora_rank=4, partition_method="homo",
                train_size=120, test_size=8, data_cache_dir="",
                lora_rank_per_client=[2, 2, 2, 4, 4, 4])


def test_fedllm_mesh_matches_the_single_device_round():
    """3 clients on 2 ranks (one pad row), heterogeneous adapter ranks:
    the adapters and the round losses of the mesh regime against
    ``FedLLMAPI`` on one device, from the same adapters."""
    from fedml_tpu_torch import data as t_data
    from fedml_tpu_torch.llm.fedllm import FedLLMAPI
    args = t_arguments().update(**_llm_cfg())
    ds, _ = t_data.load(args)
    one = FedLLMAPI(args, ds, device="cpu")
    init = {k: v.numpy().copy() for k, v in one.global_lora.items()}
    ms = [one.train_one_round(r) for r in range(2)]
    res = spawn("tests.torch_mesh_ranks:fedllm", 2,
                (_llm_cfg(), 2, init), timeout=SPAWN_TIMEOUT)[0]
    assert res["steps"] == [m["steps"] for m in ms]
    np.testing.assert_allclose(res["losses"], [m["train_loss"] for m in ms],
                               atol=1e-6, rtol=0)
    for k, v in one.global_lora.items():
        np.testing.assert_allclose(res["lora"][k], v.numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)


# -- the card a rank takes ----------------------------------------------------

def test_card_index_follows_local_rank(monkeypatch):
    """A lone process takes card 0; a rank of a process group
    (``LOCAL_RANK`` set by torchrun or the launcher) takes its own card,
    so the ranks of one host never share one."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert t_device.card_index() == 0
    assert t_device.card_device() == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert t_device.card_index() == 3
    assert t_device.card_device() == torch.device("cuda", 3)
    assert t_device.get_device(None, "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_device.get_device(None, "cuda")
