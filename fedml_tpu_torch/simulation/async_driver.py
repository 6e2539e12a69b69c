"""Multi-rank buffered-async federation (port of
``fedml_tpu.simulation.async_driver``): the message-plane twin of
:class:`~fedml_tpu_torch.simulation.async_engine.FedBuffAPI`.

Rank 0 (the buffering server) and ranks ``1..W`` (one per worker pool)
exchange dispatch and update messages over any comm backend of
``core/distributed/`` (``local``, ``filestore``, ``MQTT_S3``).  The server
seeds every worker with one DISPATCH (generation id, model version and
state); each worker stages that generation's cohort, reduces it to an
unfinished partial aggregate
(:class:`~fedml_tpu_torch.core.federated.PartialReducer`, the silo tier's
math), optionally sleeps an injected heavy-tailed latency, and sends the
partial up.  The server staleness-discounts each arriving partial with
:func:`~fedml_tpu_torch.core.federated.scale_partial` (``s(τ) =
1/(1+τ)^α`` against the version the worker was dispatched from), buffers
it, and once K partials have landed combines them through
``combine_partial_aggregates`` and the ``ServerOptimizer`` transition,
then re-dispatches the sender at the new version.  The buffer also
flushes at ``quorum_deadline_s`` with fewer than K partials (padded with
zero partials), and a lease-dead worker is left out of the dispatch
rotation until its lease renews.  FINISH fans out after ``comm_round``
applies.

The apply order follows arrival, which follows the threads or processes:
two runs need not apply the same partials in the same order, so this
driver is held within a bound of the in-process engine, never bitwise.
Stateless-client algorithms only (SCAFFOLD/FedDyn rows would go stale
across worker ranks).
"""

from __future__ import annotations

import logging
import queue
import time

import numpy as np
import torch

from ..core import federated
from ..core import hostrng
from ..core import rng as rng_util
from ..core import traffic
from ..core import wire
from ..core.distributed.communication.fault_injection import (
    maybe_crash_at_round)
from ..core.distributed.reliability import ReliableEndpoint
from ..core.tree import host_copy_tree
from ..obs import get_tracer
from .round_engine import draw_dropout
from .sp.fedavg_api import FedAvgAPI

log = logging.getLogger(__name__)

#: protocol message types (disjoint from the cross-silo FSM's range and
#: the silo hierarchy's 601..603)
MSG_TYPE_ASYNC_DISPATCH = 701
MSG_TYPE_ASYNC_UPDATE = 702
MSG_TYPE_ASYNC_FINISH = 703

#: hostrng purpose tag of the per-(worker, generation) latency sleeps
WORKER_LATENCY_TAG = 0xA51D1


class _AsyncEndpoint(ReliableEndpoint):
    """Queue-backed endpoint over the FedMLCommManager receive path."""

    def __init__(self, args, rank: int, size: int, backend: str):
        from ..core.distributed.fedml_comm_manager import FedMLCommManager

        inbox: "queue.Queue" = queue.Queue()

        class _Mgr(FedMLCommManager):
            def register_message_receive_handlers(self):
                for t in (MSG_TYPE_ASYNC_DISPATCH, MSG_TYPE_ASYNC_UPDATE,
                          MSG_TYPE_ASYNC_FINISH):
                    self.register_message_receive_handler(
                        t, lambda m: inbox.put(m))

        super().__init__(_Mgr(args, rank=rank, size=size, backend=backend),
                         inbox, rank)


def run_async_federation(args, device, dataset, model, api=None):
    """Drive ONE rank of the multi-rank buffered-async topology.

    ``args.rank`` 0 is the buffering server; ranks ``1..async_workers``
    run dispatch generations.  Every rank shares ``random_seed``, so
    cohort sampling, dropout masks and batch schedules are the in-process
    engine's.  ``api``: this rank's ``FedAvgAPI`` when the caller built
    it.  Returns the server's per-apply metrics list on rank 0, None on
    workers."""
    rank = int(getattr(args, "rank", 0))
    workers = int(getattr(args, "async_workers", 0) or 2)
    backend = str(getattr(args, "backend", "local"))
    if bool(getattr(args, "reliable_delivery", False)):
        # dispatch/update/finish get ack/retransmit; heartbeat leases
        # drive dead-worker exclusion
        if not getattr(args, "reliable_types", None):
            args.reliable_types = [MSG_TYPE_ASYNC_DISPATCH,
                                   MSG_TYPE_ASYNC_UPDATE,
                                   MSG_TYPE_ASYNC_FINISH]
        if not getattr(args, "heartbeat_interval_s", 0.0):
            args.heartbeat_interval_s = 0.5
        if not getattr(args, "lease_s", 0.0):
            args.lease_s = 5.0
    tracer = get_tracer()
    if bool(getattr(args, "trace", False)) or tracer.enabled:
        from ..obs import configure
        configure(label="server" if rank == 0 else f"worker{rank}")
        tracer = get_tracer()

    base = str(getattr(args, "async_base_optimizer", "") or "fedavg")
    if str(getattr(args, "federated_optimizer", "")).lower() == "fedbuff":
        args.federated_optimizer = base
    if api is None:
        api = FedAvgAPI(args, device, dataset, model)
    if api.server_opt.spec.client_state:
        raise ValueError(
            "distributed async federation supports stateless-client "
            "algorithms (SCAFFOLD/FedDyn rows would go stale across "
            "worker processes; run those in-process)")

    ep = _AsyncEndpoint(args, rank, workers + 1, backend)
    try:
        if rank == 0:
            return _run_async_server(api, ep, workers, args, tracer)
        _run_async_worker(api, ep, rank, args, tracer)
        return None
    finally:
        # rank 0 grants in-flight reliable FINISHes a short ack window
        ep.close(flush_s=2.0 if rank == 0 else 0.0)
        tracer.close()


def _run_async_server(api, ep, workers, args, tracer):
    """Rank 0: buffer staleness-discounted partials, apply at K, re-dispatch
    the sender at the new version."""
    from ..core.distributed.communication.message import Message

    # per-worker dispatch links: workers receive the state at different
    # versions, so each (server → worker) edge keeps its own EF residual
    layout = wire.ParamLayout.of(api.model)
    order = list(layout.names)
    codec = wire.codec_from_args(args, layout)
    wire_link = wire.WireLink(codec) if codec is not None else None

    spec = api.server_opt.spec
    rounds = int(getattr(args, "comm_round", 1))
    k = int(getattr(args, "async_buffer_k", 0) or 0) or workers
    alpha = float(getattr(args, "async_alpha", 0.5))
    max_staleness = int(getattr(args, "async_max_staleness", 0) or 0)
    deadline_s = float(getattr(args, "quorum_deadline_s", 0.0) or 0.0)
    recv_timeout_s = float(getattr(args, "comm_recv_timeout_s", 120.0)
                           or 120.0)
    guard = ep.guard
    if guard is not None:
        guard.start_heartbeats(expected_ranks=range(1, workers + 1))

    def dispatch(worker: int, gen: int, version: int):
        msg = Message(MSG_TYPE_ASYNC_DISPATCH, 0, worker)
        msg.add_params("gen", gen)
        msg.add_params("version", version)
        sd = wire.state_tree(api.state)
        if wire_link is not None:
            with tracer.span("wire.encode", cat="comm", version=version,
                             link=f"state:{worker}"):
                sd = wire_link.encode(sd, link=f"state:{worker}")
        msg.add_params("state", sd)
        ep.send(msg)

    version = 0
    gen = 0
    for w in range(1, workers + 1):
        dispatch(w, gen, version)
        gen += 1

    history = []
    buffered, loss_w, w_sum, stales = [], 0.0, 0.0, []
    applies = 0
    dropped = 0
    pending_redispatch = []
    t0 = time.time()
    last_apply = time.monotonic()
    last_arrival = time.monotonic()

    def apply_buffer(flushed: bool):
        nonlocal buffered, loss_w, w_sum, stales, version, applies, t0
        parts = list(buffered)
        if len(parts) < k:
            # deadline flush: pad to K with zero partials (exact)
            parts += [federated.zero_like_partial(parts[0])] * \
                (k - len(parts))
        with tracer.span("async.apply", cat="round", version=version,
                         quorum=len(buffered)):
            agg = federated.combine_partial_aggregates(spec, parts)
            api.state = api.server_opt.update_from_aggregates(api.state,
                                                              agg)
        tracer.counter("comm.quorum_size", float(len(buffered)))
        tracer.counter("comm.quorum_deficit",
                       float(k - len(buffered)) if flushed else 0.0)
        history.append({
            "round": applies, "train_loss": loss_w / max(w_sum, 1e-9),
            "round_time": time.time() - t0,
            "staleness_p50": float(np.percentile(stales, 50))
            if stales else 0.0,
            "updates_dropped": dropped,
            "buffer_fill": len(buffered), "deadline_flush": flushed})
        log.info("async server apply %d: train_loss=%.4f (%d/%d %s)",
                 applies, history[-1]["train_loss"], len(buffered), k,
                 "deadline-flush" if flushed else "full")
        buffered, loss_w, w_sum, stales = [], 0.0, 0.0, []
        version += 1
        applies += 1
        t0 = time.time()

    while applies < rounds:
        if guard is not None:
            dead = guard.dead_ranks()
            tracer.counter("comm.dead_ranks", float(len(dead)))
            if pending_redispatch:
                # a healed worker (lease renewed) rejoins the rotation at
                # the current version
                for w in [w for w in pending_redispatch if w not in dead]:
                    pending_redispatch.remove(w)
                    dispatch(w, gen, version)
                    gen += 1
        msg = ep.poll(timeout_s=0.05)
        if msg is None:
            if deadline_s > 0 and buffered \
                    and time.monotonic() - last_apply >= deadline_s:
                apply_buffer(flushed=True)
                last_apply = time.monotonic()
            elif time.monotonic() - last_arrival > recv_timeout_s:
                raise TimeoutError(
                    f"rank 0: no MSG_TYPE_ASYNC_UPDATE within "
                    f"{time.monotonic() - last_arrival:.1f}s at apply "
                    f"{applies} (comm_recv_timeout_s={recv_timeout_s:g})"
                    " — all workers dead or partitioned")
            continue
        last_arrival = time.monotonic()
        if msg.get_type() != MSG_TYPE_ASYNC_UPDATE:
            continue
        sender = int(msg.get("worker"))
        tau = version - int(msg.get("version"))
        if max_staleness and tau > max_staleness:
            dropped += 1
        else:
            s = float((1.0 + tau) ** (-alpha))
            partial = wire.tensor_tree(
                wire.maybe_decode(msg.get("partial"), layout), api.device,
                order)
            buffered.append(federated.scale_partial(spec, partial, s))
            loss_w += s * float(np.asarray(msg.get("loss_w")))
            w_sum += s * float(msg.get("w_sum"))
            stales.append(tau)
        if len(buffered) >= k:
            apply_buffer(flushed=False)
            last_apply = time.monotonic()
        if applies < rounds:
            if guard is not None and sender in guard.dead_ranks():
                # declared dead: out of the rotation until its lease
                # renews (the heal path above re-admits it)
                pending_redispatch.append(sender)
            else:
                dispatch(sender, gen, version)
                gen += 1
    for w in range(1, workers + 1):
        ep.send(Message(MSG_TYPE_ASYNC_FINISH, 0, w))
    return history


def _run_async_worker(api, ep, rank, args, tracer):
    """Ranks 1..W: stage the dispatched generation's cohort, reduce it to
    an unfinished partial, sleep the injected heavy-tailed latency, send
    the update up, wait for the next dispatch.

    ``wire_precision`` quantizes the uploaded partial on this worker's own
    EF link; ``wire_overlap`` starts the partial's copy to pinned host
    memory on the producing stream and moves the encode and send to a
    writer thread, which waits on the copy's event first."""
    from concurrent.futures import ThreadPoolExecutor

    from ..core.distributed.communication.message import Message

    spec = api.server_opt.spec
    server_opt = api.server_opt
    program = federated.RoundProgram(spec, api.trainer.make_local_train(),
                                     server_opt, api._client_mode)
    layout = wire.ParamLayout.of(api.model)

    def partial_fn(state, idx, mask, w, generator):
        drop = draw_dropout(api.model, generator, idx.shape[:3])
        rows = idx.to(torch.long)
        outs = program.run_clients(state, api._dev_x[rows],
                                   api._dev_y[rows], mask, drop, None)
        partial = federated.build_aggregates(
            spec, federated.PartialReducer(), server_opt, state, outs, w)
        return partial, torch.sum(outs.loss * w), torch.sum(w)

    lat_median = float(getattr(args, "async_latency_median_s", 0.0) or 0.0)
    lat_sigma = float(getattr(args, "async_latency_sigma", 1.5) or 1.5)
    seed = int(getattr(args, "random_seed", 0))
    guard = ep.guard
    if guard is not None:
        guard.start_heartbeats()
    recv_timeout_s = float(getattr(args, "comm_recv_timeout_s", 120.0)
                           or 120.0)
    codec = wire.codec_from_args(args, layout)
    wire_link = wire.WireLink(codec) if codec is not None else None
    writer = (ThreadPoolExecutor(max_workers=1)
              if bool(getattr(args, "wire_overlap", False)) else None)
    pending = None

    def upload(gen, version, partial, lw, ws, event=None):
        if event is not None:
            event.synchronize()
        sd = partial
        if wire_link is not None:
            with tracer.span("wire.encode", cat="comm", gen=gen,
                             link="partial"):
                sd = wire_link.encode(sd, link="partial")
        up = Message(MSG_TYPE_ASYNC_UPDATE, rank, 0)
        up.add_params("gen", gen)
        up.add_params("version", version)
        up.add_params("worker", rank)
        up.add_params("partial", sd)
        up.add_params("loss_w", np.asarray(float(lw), np.float32))
        up.add_params("w_sum", float(ws))
        ep.send(up)

    dispatches = 0
    try:
        while True:
            msg = ep.recv(timeout_s=recv_timeout_s,
                          expect="MSG_TYPE_ASYNC_DISPATCH/"
                                 "MSG_TYPE_ASYNC_FINISH from rank 0")
            if msg.get_type() == MSG_TYPE_ASYNC_FINISH:
                return
            if msg.get_type() != MSG_TYPE_ASYNC_DISPATCH:
                continue
            gen = int(msg.get("gen"))
            version = int(msg.get("version"))
            # crash-at-round chaos keyed on this worker's own dispatch
            # ordinal: the buffer must flush at the deadline without it
            maybe_crash_at_round(args, rank, dispatches)
            dispatches += 1
            api.state = wire.state_from_tree(
                wire.maybe_decode(msg.get("state"), layout), api.state)
            with tracer.span("async.worker_round", cat="round", gen=gen,
                             worker=rank):
                _clients, idx, mask, w, _steps = api._stage_round_arrays(
                    gen)
                idx, mask, w = api._to_device(idx, mask, w)
                partial, lw, ws = partial_fn(
                    api.state, idx, mask, w,
                    rng_util.round_key(api._root, gen))
                if lat_median > 0:
                    rng = hostrng.gen(seed, WORKER_LATENCY_TAG, rank, gen)
                    time.sleep(float(traffic.lognormal_latencies(
                        rng, lat_median, lat_sigma, 1)[0]))
            if writer is not None:
                host, event = host_copy_tree(
                    {"partial": partial, "lw": lw, "ws": ws})
                if pending is not None:
                    pending.result()   # surface the previous upload first
                pending = writer.submit(upload, gen, version,
                                        host["partial"], host["lw"],
                                        host["ws"], event)
            else:
                upload(gen, version, partial, lw, ws)
    finally:
        if writer is not None:
            if pending is not None:
                pending.result()
            writer.shutdown(wait=True)


__all__ = ["run_async_federation", "MSG_TYPE_ASYNC_DISPATCH",
           "MSG_TYPE_ASYNC_UPDATE", "MSG_TYPE_ASYNC_FINISH"]
