"""Device-carry round telemetry (port of ``fedml_tpu.obs.carry``): the
per-round ``ObsCarry`` row.

A handful of f32 scalars (plus one ``(4,)`` vector of per-phase FLOP
weights) computed on the round's device from quantities the round already
has, returned through the same metrics dict the loss rides — stacked to
``(K,)`` by a fused block (one static output of the captured graph) — and
read on the host only at the round loop's existing log-round or block
sync.

The JAX package's ``ObsCarry`` is a ``flax.struct`` pytree; here it is a
flat dict of f32 tensors keyed by :data:`OBS_FIELDS`, because the block
graph's static buffers (``round_engine.BlockRoundFn``) already move dicts
of tensors.  Where the JAX package computes the row in every round (XLA
fuses it for free), the port's round builders compute it only when the
tracer is enabled at build time: in an eager round each reduction is a
launch of its own.

The phase FLOP weights are attribution weights, not exact counts:
``tools/fedtrace.py summarize`` apportions each round's measured
wall-clock across the device phases proportionally to them.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from .tracer import DEVICE_PHASES

#: server-update FLOPs/param attribution class per algorithm (the JAX
#: package's table: plain wavg ≈ 2, Adam-family moments ≈ 18, control
#: variate / residual updates in between) — weights for time attribution,
#: not exact counts
OPT_FLOPS = {
    "fedavg": 2.0, "fedavg_seq": 2.0, "fedprox": 2.0, "fedsgd": 4.0,
    "fedopt": 18.0, "fedopt_seq": 18.0, "scaffold": 8.0, "feddyn": 10.0,
    "fednova": 6.0, "mime": 10.0,
}

#: the fields of one ObsCarry row, in the JAX dataclass's order; every
#: field is an f32 scalar but ``phase_flops``, a ``(4,)`` vector aligned
#: with :data:`~fedml_tpu_torch.obs.tracer.DEVICE_PHASES`
OBS_FIELDS = ("steps", "clients", "examples", "update_norm", "phase_flops",
              "collective_bytes", "quant_error_norm",
              "collective_bytes_client", "collective_bytes_stage",
              "collective_bytes_model")

ObsCarry = Dict[str, torch.Tensor]


def param_count(tree: Mapping) -> int:
    """Element count of a ``{name: tensor}`` params dict."""
    return sum(int(v.numel()) for v in tree.values())


def update_sq(old: Mapping, new: Mapping) -> torch.Tensor:
    """``‖new − old‖²`` over every leaf, in f32."""
    f32 = torch.float32
    return sum(torch.sum((new[k].to(f32) - old[k].to(f32)) ** 2)
               for k in old)


def round_obs(old_params: Mapping, new_params: Mapping, *, real_steps,
              real_clients, batch: int, feat: int,
              opt_flops_per_param: float, collective_bytes: float = 0.0,
              collective_bytes_client: float = None,
              collective_bytes_stage: float = 0.0,
              collective_bytes_model: float = 0.0, quant_error=None,
              sq: torch.Tensor = None, n_params: int = None) -> ObsCarry:
    """One round's ObsCarry, on the round's device.

    ``real_steps``/``real_clients`` are device scalars the round already
    computes; ``batch``/``feat`` (examples per step, elements per example),
    the param count and the byte models are host statics, so every phase
    weight is a static × device product and the only reduction is the
    update norm.  ``sq`` (the update's squared norm) and ``n_params`` are
    given by a mesh round whose params are this rank's shards.  No value
    is read back to the host, so the row can live inside a captured CUDA
    graph."""
    f32 = torch.float32
    p = float(param_count(old_params) if n_params is None else n_params)
    steps = torch.as_tensor(real_steps).to(f32)
    dev = steps.device

    def const(v):
        return torch.full((), float(v), dtype=f32, device=dev)

    clients = torch.as_tensor(real_clients).to(f32)
    examples = steps * float(batch)
    if sq is None:
        sq = update_sq(old_params, new_params)
    phase_flops = torch.stack([
        examples * float(max(int(feat), 1)),        # gather: elements moved
        (6.0 * p) * examples,                       # client steps: fwd+bwd
        (2.0 * p) * clients,                        # merge: weighted sums
        const(float(opt_flops_per_param) * p),      # server update
    ])
    if collective_bytes_client is None:
        # single-axis engines (sp, 1-D mesh): all modeled bytes cross the
        # client axis
        collective_bytes_client = collective_bytes
    return {
        "steps": steps, "clients": clients, "examples": examples,
        "update_norm": torch.sqrt(sq.to(f32)), "phase_flops": phase_flops,
        "collective_bytes": const(collective_bytes),
        "quant_error_norm": (const(0.0) if quant_error is None
                             else quant_error.to(f32)),
        "collective_bytes_client": const(collective_bytes_client),
        "collective_bytes_stage": const(collective_bytes_stage),
        "collective_bytes_model": const(collective_bytes_model),
    }


# -- host-side materialization (called only at the round loop's existing
#    sync points, on values it has already copied to the host) ---------

def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _row(steps, clients, examples, norm, pf, cbytes, qerr, cb_client,
         cb_stage, cb_model) -> Dict[str, float]:
    out = {"steps": float(steps), "clients": float(clients),
           "examples": float(examples), "update_norm": float(norm)}
    for i, phase in enumerate(DEVICE_PHASES):
        out[f"flops_{phase}"] = float(pf[i])
    out["collective_bytes"] = float(cbytes)
    out["quant_error_norm"] = float(qerr)
    out["collective_bytes_client"] = float(cb_client)
    out["collective_bytes_stage"] = float(cb_stage)
    out["collective_bytes_model"] = float(cb_model)
    return out


def obs_host(carry: Mapping) -> Dict[str, float]:
    """A scalar ObsCarry (host arrays or tensors) as plain host floats."""
    return _row(*(_np(carry[f]) for f in OBS_FIELDS))


def obs_host_rows(carry: Mapping) -> List[Dict[str, float]]:
    """A block-stacked ``(K,)`` ObsCarry as K row dicts (one host copy per
    field, then pure indexing)."""
    cols = [_np(carry[f]) for f in OBS_FIELDS]
    if cols[0].ndim == 0:
        return [_row(*cols)]
    return [_row(*(c[j] for c in cols)) for j in range(cols[0].shape[0])]


def obs_population_rows(carry: Mapping, losses) -> List[Dict[str, float]]:
    """A population's ObsCarry as per-round rows.

    ``carry`` leaves are ``(P,)`` (one round, P members) or ``(K, P)`` (a
    fused block: the port stacks a block's rounds on the leading axis);
    ``losses`` is ``(P,)`` or ``(P, K)`` (the records' layout).  Fields
    equal across members (steps/clients/examples, the static byte models)
    collapse under the member mean; ``update_norm``/``quant_error_norm``
    differ per member and report the mean.  Each row also carries the
    member count and the best / worst / mean member loss, and the spread
    of the byte model across members (0: one program)."""
    losses = _np(losses)
    fused = losses.ndim == 2
    if not fused:
        losses = losses[:, None]
    p, k = losses.shape
    cols = {f: _np(carry[f]) for f in OBS_FIELDS}

    def col(f, j):
        a = cols[f][j] if fused else cols[f]
        return a.mean(axis=0)

    rows = []
    for j in range(k):
        row = _row(*(col(f, j) for f in OBS_FIELDS))
        row["members"] = float(p)
        row["member_loss_best"] = float(losses[:, j].min())
        row["member_loss_worst"] = float(losses[:, j].max())
        row["member_loss_mean"] = float(losses[:, j].mean())
        cb = cols["collective_bytes"][j] if fused \
            else cols["collective_bytes"]
        row["member_bytes_spread"] = float(cb.max() - cb.min())
        rows.append(row)
    return rows
