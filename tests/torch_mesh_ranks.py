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
