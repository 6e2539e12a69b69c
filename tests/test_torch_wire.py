"""The port's fedwire codec (``core/wire.py``) and wire checkpoints
(``core/checkpoint.py::WireCheckpointer``) against the JAX package's.

- on identical trees the port's payloads encode to the JAX codec's bytes
  at fp32, bf16 and int8: the raw sidecar, root lists, empty dicts and
  ``None`` leaves included, and each side decodes the other's payload;
- on params carried across from a JAX model (a Conv and a Dense layer),
  the codec given the model's ``ParamLayout`` writes the JAX payload byte
  for byte, the int8 vector and its error feedback included, and decodes
  back into the model's names, order and layout;
- error feedback advances once per encode, never per decode, per link;
- precision validation, and the wire-format checkpoint: round trip and
  pruning, ``FedAvgAPI`` resuming bitwise, and each package reading the
  other's file.
"""

import flax.serialization as fser
import jax
import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu.core import wire as jw
from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.core import checkpoint as t_ckpt
from fedml_tpu_torch.core import wire as tw
from fedml_tpu_torch.core.distributed.communication.message import (
    decode_tree, encode_tree)
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

from .torch_sp_parity import CNN_WEB, build, port_tree, tiny

PRECISIONS = ("fp32", "bf16", "int8")
#: tiny models only quantize below the default 256-element block
WIRE_BLOCK = 16


def flaxish(rng):
    """tests/test_wire.py's state dict: nested dicts, an optax-chain list,
    an empty dict, a None leaf, integer bookkeeping and float leaves on
    both sides of the block threshold."""
    return {
        "params": {"w": rng.normal(size=(30, 10)).astype(np.float32),
                   "b": np.arange(10, dtype=np.float32)},
        "opt_state": [
            {"mu": {"w": rng.normal(size=300).astype(np.float32)},
             "count": np.int32(3)},
            {},
        ],
        "c_round": None,
        "step": np.int64(7),
    }


def assert_sd_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (a, b)
        for k in a:
            assert_sd_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_sd_equal(x, y)
    elif a is None:
        assert b is None
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("prec", PRECISIONS)
def test_payload_bytes_are_the_jax_codecs(prec):
    rng = np.random.default_rng(0)
    root_list = [{"a": rng.normal(size=128).astype(np.float32)},
                 rng.normal(size=64).astype(np.float32)]
    for tree, block in ((flaxish(rng), 64), (root_list, 32)):
        jp, _ = jw.WireCodec(prec, block=block).encode(tree)
        tp, _ = tw.WireCodec(prec, block=block).encode(tree)
        blob = encode_tree(tp)
        assert blob == fser.msgpack_serialize(jp)
        # each side decodes the other's payload, from the bytes
        assert_sd_equal(tw.WireCodec.decode(fser.msgpack_restore(blob)),
                        jw.WireCodec.decode(jp))
        assert_sd_equal(jw.WireCodec.decode(fser.msgpack_restore(blob)),
                        tw.WireCodec.decode(decode_tree(blob)))
    # the sidecar and the structural records rode along
    assert tp["lists"] == [""]
    sd = flaxish(np.random.default_rng(9))
    p, _ = tw.WireCodec(prec, block=64).encode(sd)
    assert p["nones"] == ["c_round"] and p["empties"] == ["opt_state/1"]
    assert {p["paths"][int(i)] for i in p["raw"]} == {
        "opt_state/0/count", "params/b", "step"}
    got = tw.maybe_decode(p)
    assert got["opt_state"][1] == {} and got["c_round"] is None
    assert tw.maybe_decode(sd) is sd
    if prec == "fp32":
        assert_sd_equal(sd, got)


@pytest.fixture(scope="module")
def carried():
    """A JAX cnn_web engine and the port's, the port on the JAX weights."""
    ja, ta, tm = build(tiny(**CNN_WEB), jax_fedavg(), FedAvgAPI)
    ta.reset_params(port_tree(ja.state.global_params, tm))
    return ja, ta, tm


def jax_fedavg():
    from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as J
    return J


@pytest.mark.parametrize("prec", PRECISIONS)
def test_model_layout_payloads_are_jaxs(carried, prec):
    """A partial ``{num, den}`` over carried-across params, encoded twice
    on one link (the second with the int8 residual): the JAX payload byte
    for byte.  Decoded, it is the port's params dict in the model's
    order."""
    ja, ta, tm = carried
    layout = tw.ParamLayout.of(tm)
    jparams = jax.device_get(ja.state.global_params)
    tparams = ta.state.global_params
    jl = jw.WireLink(jw.WireCodec(prec, block=WIRE_BLOCK))
    tl = tw.WireLink(tw.WireCodec(prec, block=WIRE_BLOCK, layout=layout))
    for step in range(2):
        scale = np.float32(1.5 + step)
        jpart = {"avg_params": {"num": jax.tree_util.tree_map(
            lambda a: a * scale, jparams), "den": np.float32(scale)},
            "n_sampled": np.float32(4.0)}
        tpart = {"avg_params": {"num": {k: v * float(scale)
                                        for k, v in tparams.items()},
                                "den": torch.tensor(float(scale))},
                 "n_sampled": torch.tensor(4.0)}
        jp, tp = jl.encode(jpart, link="p"), tl.encode(tpart, link="p")
        assert encode_tree(tp) == fser.msgpack_serialize(jp), step
    if prec == "int8":
        np.testing.assert_array_equal(tl.ef("p"), jl.ef("p"))
    got = tw.WireCodec.decode(jp, layout)["avg_params"]["num"]
    want = port_tree(jw.WireCodec.decode(jp)["avg_params"]["num"], tm)
    assert list(got) == list(tparams)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy())
    # the server state's sync: the JAX package's state dict, bitwise
    jsync, _ = jw.WireCodec(prec, block=WIRE_BLOCK).encode(
        fser.to_state_dict(ja.state))
    tsync, _ = tl.codec.encode(tw.state_tree(ta.state))
    assert encode_tree(tsync) == fser.msgpack_serialize(jsync)
    back = tw.state_from_tree(tw.WireCodec.decode(tsync, layout), ta.state)
    if prec == "fp32":
        assert all(torch.equal(back.global_params[k], v)
                   for k, v in tparams.items())


def test_ef_advances_once_per_encode_and_links_are_independent():
    rng = np.random.default_rng(5)
    vec = rng.normal(size=256).astype(np.float32)
    sd = {"w": torch.from_numpy(vec)}
    link = tw.WireLink(tw.WireCodec("int8", block=64))
    p1 = link.encode(sd, link="partial")
    ef1 = np.array(link.ef("partial"), copy=True)
    np.testing.assert_allclose(
        ef1, vec - tw.WireCodec.decode(p1)["w"], atol=1e-6)
    tw.WireCodec.decode(p1)
    link.decode(p1)
    np.testing.assert_array_equal(link.ef("partial"), ef1)
    p2 = link.encode(sd, link="partial")
    ef2 = link.ef("partial")
    np.testing.assert_allclose(vec + ef1,
                               tw.WireCodec.decode(p2)["w"] + ef2, atol=1e-6)
    assert not np.array_equal(ef1, ef2)
    p3 = link.encode(sd, link="other")
    np.testing.assert_array_equal(p3["q"], p1["q"])
    np.testing.assert_array_equal(p3["s"], p1["s"])
    for prec in ("fp32", "bf16"):
        other = tw.WireLink(tw.WireCodec(prec, block=64))
        other.encode(sd, link="partial")
        assert other.ef("partial") is None
    assert tw.payload_nbytes(p1) == tw.WireCodec(
        "int8", block=64).modeled_nbytes(256, p1["raw"]) == 256 + 4 * 4


def test_precision_validation():
    with pytest.raises(ValueError, match="unknown wire precision"):
        tw.WireCodec("fp16")
    args = fedml_tpu_torch.load_arguments()
    assert tw.wire_precision(args) == "off"
    assert tw.codec_from_args(args) is None
    args.update(wire_precision="int4")
    with pytest.raises(ValueError, match="unknown wire_precision"):
        tw.wire_precision(args)
    with pytest.raises(ValueError, match="unknown wire_precision"):
        fedml_tpu_torch.init(args, should_init_logs=False)
    with pytest.raises(ValueError, match="unknown checkpoint_codec"):
        fedml_tpu_torch.init(fedml_tpu_torch.load_arguments().update(
            checkpoint_codec="zip"), should_init_logs=False)
    args.update(wire_precision="BF16", wire_block=0, quant_block=64)
    codec = tw.codec_from_args(args)
    assert (codec.precision, codec.block) == ("bf16", 64)


def test_wire_checkpointer_round_trip_and_prune(tmp_path):
    from fedml_tpu.core.checkpoint import WireCheckpointer as JCk
    rng = np.random.default_rng(8)

    def mk(step):
        state = {"params/w": torch.from_numpy(
            rng.normal(size=300).astype(np.float32) + step),
            "params/b": torch.arange(3, dtype=torch.float32),
            "round_idx": torch.tensor(step, dtype=torch.int64)}
        table = {"c": torch.from_numpy(
            rng.normal(size=(12, 3)).astype(np.float32))}
        return state, table

    ck = t_ckpt.WireCheckpointer(str(tmp_path), max_to_keep=2)
    saved = {}
    for step in range(3):
        saved[step] = mk(step)
        ck.save(step, *saved[step])
    assert ck.latest_round() == 2
    assert sorted(p.name for p in tmp_path.glob("wire_*.msgpack")) == \
        ["wire_1.msgpack", "wire_2.msgpack"]
    template = ({k: torch.zeros_like(v) for k, v in saved[2][0].items()},
                {"c": torch.zeros(12, 3)})
    state, table = ck.restore(template=template)
    for got, want in ((state, saved[2][0]), (table, saved[2][1])):
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(ck.restore_state(1)["params/w"],
                       saved[1][0]["params/w"])
    # the JAX package reads the port's file: a self-describing payload
    jsd = JCk(str(tmp_path)).restore_state(2)
    np.testing.assert_array_equal(jsd["params"]["w"],
                                  saved[2][0]["params/w"].numpy())


def test_fedavg_resumes_bitwise_and_reads_a_jax_checkpoint(tmp_path):
    cfg = tiny(checkpoint_codec="wire", checkpoint_freq=1, comm_round=3)

    def port_api(d):
        a = fedml_tpu_torch.load_arguments().update(
            **dict(cfg, checkpoint_dir=str(d)))
        ds, n = t_data.load(a)
        return FedAvgAPI(a, "cpu", ds, t_model.create(a, n))

    api = port_api(tmp_path / "port")
    assert isinstance(api._checkpointer(), t_ckpt.WireCheckpointer)
    for r in range(2):
        api.train_one_round(r)
        api.maybe_checkpoint(r)
    fresh = port_api(tmp_path / "port")
    assert fresh.maybe_resume() == 2
    assert fresh.state.round_idx == api.state.round_idx
    for p in (api, fresh):
        p.train_one_round(2)
    assert all(torch.equal(fresh.state.global_params[k], v)
               for k, v in api.state.global_params.items())

    # a JAX run's wire checkpoint restores into the port's engine
    ja, _, tm = build(dict(cfg, checkpoint_dir=str(tmp_path / "jax")),
                      jax_fedavg(), FedAvgAPI)
    for r in range(2):
        ja.train_one_round(r)
        ja.maybe_checkpoint(r)
    reader = port_api(tmp_path / "jax")
    assert reader.maybe_resume() == 2
    want = port_tree(ja.state.global_params, tm)
    assert list(reader.state.global_params) == list(want)
    assert all(torch.equal(reader.state.global_params[k], v)
               for k, v in want.items())
