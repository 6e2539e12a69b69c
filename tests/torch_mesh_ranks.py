"""Rank bodies of the port's multi-rank mesh tests
(``tests/test_torch_mesh*.py``), run by
``fedml_tpu_torch.simulation.mesh.launch.spawn`` in fresh processes over
gloo.  This module imports the port only, never JAX, so the spawned ranks
do not load it.  Every function runs on every rank (the collectives need
them all) and rank 0 returns the results as numpy."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from fedml_tpu_torch import data as t_data
from fedml_tpu_torch import model as t_model
from fedml_tpu_torch.arguments import load_arguments


def to_np(obj):
    """A nest of tensors, dicts, tuples and dataclasses as numpy."""
    import dataclasses
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().float().numpy() \
            if obj.dtype == torch.bfloat16 else obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_np(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_np(v) for v in obj)
    if dataclasses.is_dataclass(obj):
        return {f.name: to_np(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj


def _build(cls, cfg, **kw):
    args = load_arguments().update(**cfg)
    ds, out = t_data.load(args)
    return cls(args, "cpu", ds, t_model.create(args, out), **kw)


def _rank0(value):
    return value if dist.get_rank() == 0 else None


def mesh_cases(cases):
    """Each case ``(cfg, rounds, init, noise)``: a ``MeshFedAvgAPI`` on the
    world's mesh, restarted from ``init`` (a port params dict of numpy, or
    None), its quantization noise from ``noise`` (``{(round, shard,
    slot): array}``, or None), ``rounds`` rounds.  Returns per case the
    losses, total steps, whole state, whole client table and the
    evaluation."""
    from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI
    out = []
    for cfg, rounds, init, noise in cases:
        api = _build(MeshFedAvgAPI, cfg)
        if init is not None:
            api.reset_params({k: torch.as_tensor(v) for k, v in
                              init.items()})
        if noise is not None:
            api.quant_noise = (lambda r, shard, slot, kind, shape:
                               noise[(r, shard, slot)])
        ms = [api.train_one_round(r) for r in range(rounds)]
        res = dict(losses=[float(m["train_loss"]) for m in ms],
                   steps=[float(m["total_steps"]) for m in ms],
                   state=to_np(api.full_state()),
                   table=to_np(api.full_client_table()),
                   layout=api.update_sharding, shards=api.n_shards,
                   precision=api.collective_precision,
                   eval=api.evaluate())
        api._stager.close()
        out.append(res)
    return _rank0(out)


def mesh_train(cfgs):
    """``run_simulation``'s path on the world's mesh for each config:
    ``train()`` through ``SimulatorMesh`` (the per-round records kept)."""
    return _rank0([_train(cfg) for cfg in cfgs])


def _train(cfg):
    from fedml_tpu_torch.runner import FedMLRunner
    args = load_arguments().update(**cfg)
    args.training_type, args.backend = "simulation", cfg.get("backend",
                                                             "mesh")
    ds, out = t_data.load(args)
    runner = FedMLRunner(args, torch.device("cpu"), ds,
                         t_model.create(args, out))
    params = runner.run()
    api = runner.runner.fl_trainer
    return dict(params=to_np(params),
                losses=[r["train_loss"] for r in
                        getattr(api, "metrics_history", [])],
                type=type(api).__name__)


def hierarchical(cfg, rounds, init):
    from fedml_tpu_torch.simulation.mesh.hierarchical_mesh import \
        MeshHierarchicalAPI
    api = _build(MeshHierarchicalAPI, cfg)
    api.reset_params({k: torch.as_tensor(v) for k, v in init.items()})
    losses = [float(api.train_one_round(r)["train_loss"])
              for r in range(rounds)]
    return _rank0(dict(losses=losses,
                       params=to_np(api.state.global_params),
                       eval=api.evaluate()))


def ring(cfg, rounds, init):
    from fedml_tpu_torch.simulation.mesh.decentralized_mesh import \
        MeshDecentralizedAPI
    api = _build(MeshDecentralizedAPI, cfg)
    api.params = {k: torch.stack([torch.as_tensor(v)] * api.per_shard)
                  for k, v in init.items()}
    losses = [float(api.train_one_round(r)["train_loss"])
              for r in range(rounds)]
    return _rank0(dict(losses=losses, params=to_np(api.full_params()),
                       consensus=to_np(api.consensus_params()),
                       eval=api.evaluate()))


def fedllm(cfg, rounds, init_lora):
    """``FedLLMAPI(mesh=make_mesh())`` rounds from the adapters
    ``init_lora``."""
    from fedml_tpu_torch.core.mesh import make_mesh
    from fedml_tpu_torch.llm.fedllm import FedLLMAPI
    args = load_arguments().update(**cfg)
    ds, _ = t_data.load(args)
    api = FedLLMAPI(args, ds, device="cpu",
                    mesh=make_mesh(device="cpu"))
    api.global_lora = {k: torch.as_tensor(v) for k, v in init_lora.items()}
    ms = [api.train_one_round(r) for r in range(rounds)]
    return _rank0(dict(losses=[m["train_loss"] for m in ms],
                       steps=[m["steps"] for m in ms],
                       lora=to_np(api.global_lora)))


def fail_on_rank_1():
    if dist.get_rank() == 1:
        return 1 / 0
    return "ok"


def hang_on_rank_1():
    import time
    if dist.get_rank() == 1:
        time.sleep(3600)
    return "ok"


def several(calls):
    """Each ``(target, args)`` of ``calls`` in turn on this world (one
    spawn for many bodies); rank 0 returns their results."""
    from fedml_tpu_torch.simulation.mesh.launch import _resolve
    out = [_resolve(target)(*args) for target, args in calls]
    return _rank0(out)


# -- the 2-D client x model mesh ------------------------------------------

def mesh2d_cases(cases):
    """Each case ``(cfg, rounds, init)`` on the world's 2-D mesh
    (``cfg["mesh_shape"]``): losses, the whole state, params and table,
    and this rank's resting sizes (flat state chunks, EF columns, param
    shards).  Every rank returns its own."""
    from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI
    out = []
    for cfg, rounds, init in cases:
        api = _build(MeshFedAvgAPI, cfg)
        if init is not None:
            api.reset_params({k: torch.as_tensor(v) for k, v in
                              init.items()})
        ms = [api.train_one_round(r) for r in range(rounds)]
        st = api.state
        rest = {f: int(getattr(st, f).numel()) for f in
                ("master_flat", "ef_bcast", "c_server", "h", "momentum")
                if isinstance(getattr(st, f), torch.Tensor)}
        rest.update({f"opt_state/{k}": int(v.numel()) for k, v in
                     (st.opt_state or {}).items() if v.dim() >= 1})
        res = dict(losses=[float(m["train_loss"]) for m in ms],
                   steps=[float(m["total_steps"]) for m in ms],
                   state=to_np(api.full_state()),
                   params=to_np(api.full_params()),
                   table=to_np(api.full_client_table()),
                   rest=rest,
                   ef=None if st.ef_num is None else tuple(st.ef_num.shape),
                   padded=api.flat_pad.padded_size,
                   local={k: tuple(v.shape) for k, v in
                          st.global_params.items()},
                   shards=(api.n_shards, api.n_model_shards),
                   layout=api.update_sharding, eval=api.evaluate(),
                   bytes=api.collective_bytes(), n_params=api.flat.n_params,
                   precision=api.collective_precision)
        api._stager.close()
        out.append(res)
    return out


def _state_diff(a, b):
    from fedml_tpu_torch.core.checkpoint import state_to_flat
    a, b = state_to_flat(a), state_to_flat(b)
    assert set(a) == set(b)
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def mesh2d_block(cfg):
    """``round_block`` 2 over 4 rounds on the world's 2-D mesh against
    the unfused rounds: the largest difference of the whole states."""
    from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI
    u = _build(MeshFedAvgAPI, cfg)
    for r in range(4):
        u.train_one_round(r)
    f = _build(MeshFedAvgAPI, dict(cfg, round_block=2))
    f._train_fused()
    out = _state_diff(f.full_state(), u.full_state())
    u._stager.close()
    f._stager.close()
    return _rank0(out)


def mesh2d_checkpoint(cfg, tmpdir):
    """A checkpoint round trip on the world's 2-D mesh: the whole state
    and table after 2 rounds through ``core/checkpoint.py``'s flat form
    and ``torch.save``, restored into a fresh engine, then one more round
    against the uninterrupted run.  Returns the largest differences."""
    import os
    from fedml_tpu_torch.core.checkpoint import state_from_flat, \
        state_to_flat
    from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI
    a = _build(MeshFedAvgAPI, cfg)
    for r in range(2):
        a.train_one_round(r)
    path = os.path.join(tmpdir, f"ck_{dist.get_rank()}.pt")
    torch.save({"state": state_to_flat(a.full_state()),
                "table": a.full_client_table()}, path)
    b = _build(MeshFedAvgAPI, cfg)
    saved = torch.load(path)
    b.load_full_state(state_from_flat(saved["state"], b.full_state()),
                      saved["table"])
    restored = _state_diff(b.full_state(), a.full_state())
    table = 0.0
    if saved["table"] is not None:
        tb, ta = b.full_client_table(), a.full_client_table()
        table = max(float((tb[k] - ta[k]).abs().max()) for k in ta)
    a.train_one_round(2)
    b.train_one_round(2)
    resumed = _state_diff(b.full_state(), a.full_state())
    for api in (a, b):
        api._stager.close()
    return _rank0(dict(restored=restored, table=table, resumed=resumed))


def mesh2d_forms():
    """``make_mesh2d``'s forms on the world, each rank's coordinates and
    the sums of its rank over each axis's group."""
    from fedml_tpu_torch.core.mesh import make_mesh2d
    out = {}
    for form in ("2,2", "2x2", (-1, 2), [1, 4], "4,1"):
        mesh = make_mesh2d(form, device="cpu")
        r = torch.tensor([float(mesh.rank)])
        out[str(form)] = dict(
            shape=(mesh.shape["client"], mesh.shape["model"]),
            coords=(mesh.c_coord, mesh.m_coord),
            client_sum=float(mesh.psum(r, axis="client")),
            model_sum=float(mesh.psum(r, axis="model")),
            world_sum=float(mesh.psum(r)))
    errors = []
    for bad in ("3,2", "1,3"):
        try:
            make_mesh2d(bad, device="cpu")
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


# -- tensor parallelism ------------------------------------------------------

def tp_fedllm(cfg, shape, params, lora0, rounds):
    """``FedLLMAPI(mesh=make_mesh2d(shape))`` from the JAX weights: its
    round losses, merged adapters and eval NLL, and right after init this
    rank's base: its parameters' local and whole shapes, the bytes it
    holds, and any live tensor as large as the smallest sharded weight
    that is not a parameter."""
    import gc
    from fedml_tpu_torch.core.mesh import make_mesh2d
    from fedml_tpu_torch.llm.convert import from_flax
    from fedml_tpu_torch.llm.fedllm import FedLLMAPI
    args = load_arguments().update(**cfg)
    ds, _ = t_data.load(args)
    api = FedLLMAPI(args, ds, device="cpu", mesh=make_mesh2d(shape,
                                                             device="cpu"))
    gc.collect()
    full = api.model.full_shapes()
    local = {n: tuple(p.shape) for n, p in api.model.named_parameters()}
    dims = api.model.tp_dims()
    smallest = min(int(np.prod(full[n])) for n in dims)
    ids = {id(p) for p in api.model.parameters()} | \
        {id(v) for v in api.global_lora.values()}
    stray = [tuple(t.shape) for t in gc.get_objects()
             if isinstance(t, torch.Tensor) and id(t) not in ids
             and t.numel() >= smallest]
    held = sum(p.numel() * p.element_size()
               for p in api.model.parameters())
    _, api.global_lora = from_flax(params, lora0, api.cfg, device="cpu",
                                   model=api.model)
    ms = [api.train_one_round(r) for r in range(rounds)]
    return dict(losses=[m["train_loss"] for m in ms],
                lora=to_np(api.global_lora), eval=api.evaluate(),
                per_client=api.evaluate_per_client()["per_client_nll"],
                full=full, local=local, dims=dims, stray=stray, held=held,
                kv_heads=api.model.layer_0.attention.hkv)


def tp_decode(params, cfg_kw, shape, prompt, n_new):
    """Greedy tokens of ``generate`` over this rank's tensor-parallel
    model (the JAX weights sliced by ``from_flax``) and its cache's KV
    heads."""
    import dataclasses
    from fedml_tpu_torch.core.mesh import make_mesh2d
    from fedml_tpu_torch.llm.convert import from_flax
    from fedml_tpu_torch.llm.model import TINY
    from fedml_tpu_torch.serving.templates.openai_compat import generate
    cfg = dataclasses.replace(TINY, **cfg_kw)
    model, _ = from_flax(params, None, cfg, device="cpu",
                         mesh=make_mesh2d(shape, device="cpu"))
    toks = generate(None, None, prompt, max_new_tokens=n_new,
                    buf_len=cfg.max_seq_len, model=model)
    return dict(tokens=toks,
                cache_heads=model.init_cache(1).layers[0]["k"].shape[1])


def tp_moe(params, x, dims, shape):
    """``MoEMLP(mesh=...)`` over the model group, its experts sliced from
    the JAX params: the output and this rank's expert count."""
    from fedml_tpu_torch.core.mesh import make_mesh2d
    from fedml_tpu_torch.llm.moe import MoEMLP
    dim, ffn, e, k = dims
    moe = MoEMLP(dim, ffn, e, k, mesh=make_mesh2d(shape, device="cpu"))
    with torch.no_grad():
        moe.router.kernel.copy_(torch.tensor(params["router"]["kernel"]))
        for name in ("w_gate", "w_up", "w_down"):
            getattr(moe, name).copy_(torch.tensor(
                params[name][moe.experts]))
        out = moe(torch.tensor(x))
    return dict(out=out.numpy(), experts=moe.w_gate.shape[0])


def several_each(calls):
    """As :func:`several`, every rank returning its own results."""
    from fedml_tpu_torch.simulation.mesh.launch import _resolve
    return [_resolve(target)(*args) for target, args in calls]


# -- the 3-D pipeline, ring attention and the mesh's client-state plane -----

def pipeline_apply_case(ws, bs, micro, tgt):
    """``ops.pipeline.pipeline_apply`` over a stage group of the whole
    world (``tanh(x W_s + b_s)`` stages): the output, and this rank's
    stage's gradients of ``sum((out - tgt)^2)``."""
    from fedml_tpu_torch.core.mesh import make_mesh
    from fedml_tpu_torch.ops.pipeline import pipeline_apply
    mesh = make_mesh(client=1, stage=dist.get_world_size(), device="cpu")
    me = mesh.s_coord
    w = torch.tensor(ws[me], requires_grad=True)
    b = torch.tensor(bs[me], requires_grad=True)
    out = pipeline_apply(lambda p, x: torch.tanh(x @ p[0] + p[1]), (w, b),
                         torch.tensor(micro), mesh)
    torch.sum((out - torch.tensor(tgt)) ** 2).backward()
    return dict(out=to_np(out), gw=to_np(w.grad), gb=to_np(b.grad))


def mesh_block_ragged(cfg):
    """``round_block`` over ``comm_round`` rounds (a ragged last block)
    on the world's mesh against the unfused rounds: the largest
    difference of the whole states."""
    from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI
    u = _build(MeshFedAvgAPI, dict(cfg, round_block=1))
    for r in range(cfg["comm_round"]):
        u.train_one_round(r)
    f = _build(MeshFedAvgAPI, cfg)
    f._train_fused()
    out = _state_diff(f.full_state(), u.full_state())
    u._stager.close()
    f._stager.close()
    return _rank0(out)


def ring_case(q, k, v, do, causal=True):
    """Ring attention over a seq group of the whole world, this rank's
    shard of the sequence: the kernel ring's and the plain ring's output
    and gradients (under ``sum(out * do)``), as this rank's shards."""
    from fedml_tpu_torch.core.mesh import make_mesh
    from fedml_tpu_torch.ops.ring_attention import (ring_attention,
                                                    ring_attention_plain)
    n = dist.get_world_size()
    mesh = make_mesh(client=1, seq=n, device="cpu")
    me = mesh.q_coord

    def part(a):
        s = a.shape[2] // n
        return torch.tensor(a[:, :, me * s:(me + 1) * s])

    out = {}
    for name, fn in (("kernel", ring_attention),
                     ("plain", ring_attention_plain)):
        qq, kk, vv = (part(a).requires_grad_() for a in (q, k, v))
        o = fn(qq, kk, vv, mesh, causal=causal)
        torch.sum(o * part(do)).backward()
        out[name] = dict(o=to_np(o), dq=to_np(qq.grad), dk=to_np(kk.grad),
                         dv=to_np(vv.grad))
    return out


def llama_ring(params, cfg_kw, tokens):
    """``LlamaLM(attn_impl="ring")`` over a seq group of the whole world
    from the JAX weights: this rank's logits of its token shard."""
    import dataclasses
    from fedml_tpu_torch.core.mesh import make_mesh
    from fedml_tpu_torch.llm.convert import from_flax
    from fedml_tpu_torch.llm.model import TINY
    n = dist.get_world_size()
    mesh = make_mesh(client=1, seq=n, device="cpu")
    cfg = dataclasses.replace(TINY, **cfg_kw)
    model, _ = from_flax(params, None, cfg, device="cpu", mesh=mesh)
    s = tokens.shape[1] // n
    me = mesh.q_coord
    with torch.no_grad():
        return to_np(model(torch.tensor(tokens[:, me * s:(me + 1) * s])))


def mesh_state(cases, rounds):
    """Each ``(cfg, init)`` on the world's mesh, restarted from ``init``
    (a port params dict of numpy), ``rounds`` rounds: losses, whole
    params and the client store's written rows (whole, gathered from
    every rank), or the dense table."""
    from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI
    out = []
    for cfg, init in cases:
        api = _build(MeshFedAvgAPI, cfg)
        api.reset_params({k: torch.as_tensor(v) for k, v in init.items()})
        ms = [api.train_one_round(r) for r in range(rounds)]
        rows = None
        if api._pager is not None:
            api._pager.drain_writebacks()
            pay = api._store_payload()
            names = sorted(api.state.global_params)
            rows = dict(ids=pay["ids"], **{
                name: pay[f"leaf_{i}"] for i, name in enumerate(names)})
        out.append(dict(losses=[float(m["train_loss"]) for m in ms],
                        params=to_np(api.full_params()), rows=rows,
                        table=to_np(api.full_client_table()),
                        paged=api._data_pager is not None,
                        sampled=int(np.max(api._client_sampling(0))),
                        shards=(api.n_shards, api.n_stage_shards,
                                api.n_model_shards),
                        pipeline=type(api.trainer).__name__
                        == "PipelineTrainer"))
        api._stager.close()
        if api._pager is not None:
            api._pager.close()
    return _rank0(out)


def mesh3d_checkpoint(cfg, cfg_b, tmpdir):
    """A checkpoint of a 3-D run after 2 rounds (``checkpoint_dir``,
    saved by rank 0), restored by ``maybe_resume`` into a fresh engine of
    ``cfg_b`` (the same mesh, or another of the same ranks), then round 2
    there against round 2 of the run that saved it (the uninterrupted 3-D
    run).  Returns the restored state's largest difference from the saved
    one (same mesh) and the params' after round 2."""
    from fedml_tpu_torch.simulation.mesh.engine import MeshFedAvgAPI
    ck = dict(checkpoint_dir=tmpdir, checkpoint_freq=1)
    a = _build(MeshFedAvgAPI, dict(cfg, **ck))
    for r in range(2):
        a.train_one_round(r)
    a.maybe_checkpoint(1)
    b = _build(MeshFedAvgAPI, dict(cfg_b, **ck))
    start = b.maybe_resume()
    restored = _state_diff(b.full_state(), a.full_state()) \
        if cfg_b.get("mesh_shape") == cfg.get("mesh_shape") else None
    a.train_one_round(2)
    b.train_one_round(2)
    pa, pb = a.full_params(), b.full_params()
    resumed = max(float((pb[k] - pa[k]).abs().max()) for k in pa)
    for api in (a, b):
        api._stager.close()
    return _rank0(dict(start=start, restored=restored, resumed=resumed,
                       shards=(b.n_shards, b.n_stage_shards,
                               b.n_model_shards)))
