"""Measured per-phase device time: the out-of-band ``trace_device`` probe
(port of ``fedml_tpu.obs.devicetime``).

``fedtrace summarize``'s default device-phase breakdown apportions each
round's wall-clock by the FLOP weights the round carries (:mod:`.carry`),
a model.  This probe measures instead: it splits one round into its four
phases (gather / client_steps / merge / server_update), built from the
engine's own pieces (the device-resident dataset's gather, the round
program's client map, ``federated.build_aggregates`` and
``ServerOptimizer.update_from_aggregates``, the pieces the round
composes), and times each on the real staged cohort: min of ``repeats``
runs after a warm-up, between two ``torch.cuda.Event`` records on the
card (``time.perf_counter`` on the CPU).  It runs once, before the round
loop, behind ``args.trace_device``, so the rounds' zero-extra-sync
contract is untouched.

Results land as ``device.<phase>_s`` counters; ``fedtrace summarize``
prefers them over the FLOP model when all four are present
(``device_phase_source == "measured"``).  ``profile_dir``
(``args.trace_profile_dir``) wraps the timed section in a
``torch.profiler`` capture and writes its Chrome trace there (the JAX
module's ``jax.profiler`` capture).

Where the JAX round loop swallows a failed probe with a warning, the
port's lets it raise: a swallowed failure on the card would hide itself.
For the same reason an engine the probe cannot split (no device-resident
dataset, a population, a quantized collective layer, the mesh) raises
``NotImplementedError`` naming ``trace_device`` (the engines refuse the
option at construction), where the JAX probe warns and keeps the FLOP
model.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import torch

from .tracer import DEVICE_PHASES, get_tracer

log = logging.getLogger(__name__)


def _timed(fn, *args, repeats: int = 3):
    """``(best seconds, result)``: one warm-up call, then the minimum of
    ``repeats`` timed calls (device time between two events on the card,
    host time on the CPU)."""
    out = fn(*args)
    dev = _device_of(out)
    best = float("inf")
    for _ in range(max(int(repeats), 1)):
        if dev is not None and dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            best = min(best, time.perf_counter() - t0)
    return best, out


def _device_of(obj) -> Optional[torch.device]:
    """The device of the first tensor in ``obj`` (nested containers and
    dataclass-like objects with ``__dict__``)."""
    if isinstance(obj, torch.Tensor):
        return obj.device
    if isinstance(obj, dict):
        items = obj.values()
    elif isinstance(obj, (list, tuple)):
        items = obj
    elif hasattr(obj, "__dict__"):
        items = vars(obj).values()
    else:
        return None
    for v in items:
        d = _device_of(v)
        if d is not None:
            return d
    return None


def measure_device_phases(api, round_idx: int = 0, repeats: int = 3,
                          profile_dir: Optional[str] = None
                          ) -> Dict[str, float]:
    """Measure the four device phases of round ``round_idx`` of an sp
    engine on the device-gather path (``FedAvgAPI``, ``FedBuffAPI``).
    Returns ``{phase: seconds}`` and emits the ``device.<phase>_s``
    counters; an engine the probe cannot split raises."""
    from ..core import federated
    from ..core import rng as rng_util
    from ..simulation.round_engine import draw_dropout

    why = api._probe_refusal(api.args)
    if why:
        raise NotImplementedError(f"trace_device: {why}")

    server_opt = api.server_opt
    program = federated.RoundProgram(server_opt.spec,
                                     api.trainer.make_local_train(),
                                     server_opt, api._client_mode)
    red = federated.StackedReducer()
    clients, idx, mask, w, _steps = api._stage_round_arrays(round_idx)
    idx, mask, w = api._to_device(idx, mask, w)
    c_stacked = api._gather_c(clients, round_idx)
    drop = draw_dropout(api.model, rng_util.round_key(api._root, round_idx),
                        idx.shape[:3])
    dev_x, dev_y = api._dev_x, api._dev_y
    state = api.state

    def gather_fn(i):
        i = i.to(torch.long)
        return dev_x[i], dev_y[i]

    def client_fn(x, y):
        return program.run_clients(state, x, y, mask, drop, c_stacked)

    def merge_fn(outs):
        return federated.build_aggregates(server_opt.spec, red, server_opt,
                                          state, outs, w)

    def update_fn(agg):
        return server_opt.update_from_aggregates(state, agg)

    prof = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if idx.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        seconds: Dict[str, float] = {}
        seconds["gather"], (x, y) = _timed(gather_fn, idx, repeats=repeats)
        seconds["client_steps"], outs = _timed(client_fn, x, y,
                                               repeats=repeats)
        seconds["merge"], agg = _timed(merge_fn, outs, repeats=repeats)
        seconds["server_update"], _ = _timed(update_fn, agg,
                                             repeats=repeats)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    if prof is not None:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir,
                                              "trace_device.json"))

    tracer = get_tracer()
    for phase in DEVICE_PHASES:
        tracer.counter(f"device.{phase}_s", seconds[phase],
                       source="measured", round=round_idx)
    log.info("trace_device: measured phases %s",
             {p: round(s, 6) for p, s in seconds.items()})
    return seconds
