"""Two-tier silo → server aggregation (port of
``fedml_tpu.store.hierarchy``): the in-process driver
:class:`HierarchicalSiloAPI` and the multi-rank driver
:func:`run_silo_federation`.

A silo tier that pre-reduces its own cohort slice ships S partial
aggregates upward instead of C client updates.  Each silo reduces its
clients' outputs with the spec-driven ``build_aggregates`` and a
:class:`~fedml_tpu_torch.core.federated.PartialReducer`, so its reductions
stay unfinished ``{num, den}`` pairs; the server combines the S partials
with ``combine_partial_aggregates`` and applies the unchanged
``ServerOptimizer`` transition.  Weighted averages are associative in
their numerators, so the two-tier round equals the flat one up to float
reassociation for every registered algorithm.

Randomness: the flat round draws the whole cohort's dropout masks from
the round's generator; a silo round draws the same masks once for the
whole cohort and slices them per silo, so each client sees the masks it
sees in the flat round.

The multi-rank driver: rank 0 (the combine tier) fans the state out as
STATE_SYNC(r), ranks ``1..S`` answer with their partials over any comm
backend of ``core/distributed/`` (``local``, ``filestore``, ``MQTT_S3``),
with reliable delivery, quorum closes padded with zero partials, an
applied-round WAL with the encoded state's digest, crash-resume, the
straggler injection and, under ``wire_precision``, the fedwire codec
(``core/wire.py``: one link for the state-sync fan-out, so every silo
gets the same bytes; ``wire_overlap`` uploads on a writer thread).
"""

from __future__ import annotations

import logging
import queue
import time
import zlib

import numpy as np
import torch

from ..core import federated
from ..core import rng as rng_util
from ..core import wire
from ..core.distributed.communication.fault_injection import (
    maybe_crash_at_round)
from ..core.distributed.reliability import (KEY_UNRELIABLE,
                                             ReliableEndpoint, RoundWAL)
from ..core.tree import host_copy_tree
from ..obs import get_tracer
from ..simulation.round_engine import draw_dropout, next_pow2
from ..simulation.sp.fedavg_api import FedAvgAPI

log = logging.getLogger(__name__)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class HierarchicalSiloAPI(FedAvgAPI):
    """FedAvgAPI with the round split across ``args.num_silos`` silos.

    Each round the cohort is sliced into S equal contiguous silo cohorts,
    each reduced to a partial aggregate; one combine finishes the averages
    and runs the server transition.  Client sampling, dropout masks,
    batch schedules and weights are the flat engine's, so the only
    divergence from flat aggregation is float reassociation in the summed
    numerators.  Each silo maps its own slice of the clients, in one
    process as on a silo rank, so the in-process round and the
    multi-rank one run the same products on the same shapes (on the card
    a batched product's bits depend on its batch count).  With
    ``wire_precision`` set,
    every silo partial passes through the encode → decode the distributed
    tier ships (each silo on its own ``partial:<i>`` EF link)."""

    #: rounds of its own: no obs row, ``health`` refused by name
    OBS_ROUNDS = False

    def __init__(self, args, device, dataset, model,
                 client_mode: str = "vmap"):
        super().__init__(args, device, dataset, model, client_mode)
        self.num_silos = int(getattr(args, "num_silos", 0) or 2)
        if self.clients_per_round % self.num_silos:
            raise ValueError(
                f"client_num_per_round={self.clients_per_round} must "
                f"divide evenly into num_silos={self.num_silos} silo "
                "slices")
        if self.collective_precision != "fp32":
            raise ValueError(
                "hierarchical silo aggregation combines fp32 partial "
                "aggregates; collective_precision must stay 'fp32' — "
                "quantize the silo→server tier with wire_precision "
                "instead")
        #: the model's flax layout, shared by every wire codec of this API
        self.layout = wire.ParamLayout.of(model)
        #: the model's parameter order, restored on every received dict
        self.order = list(self.layout.names)
        codec = wire.codec_from_args(args, self.layout)
        self._wire = wire.WireLink(codec) if codec is not None else None
        self._program = None
        # one-round staging cache: the distributed driver calls
        # silo_partial() for a single slice, but staging is a pure
        # function of round_idx
        self._staged_round = None
        self._staged = None

    def _stage_round(self, round_idx: int):
        """Stage the full cohort for one round on the device, its dropout
        masks drawn once for the whole cohort.  Cached per round.  Returns
        ``(clients, idx, x, y, mask, w, drop, steps, c_stacked)``."""
        if self._staged_round == round_idx:
            return self._staged
        gen = rng_util.round_key(self._root, round_idx)
        if hasattr(self, "_dev_x"):
            clients, idx, mask, w, steps = self._stage_round_arrays(
                round_idx)
            idx, mask, w = self._to_device(idx, mask, w)
            x = y = None
            lead = idx.shape[:3]
        else:
            clients = self._client_sampling(round_idx)
            if self._data_pager is not None:
                x, y, mask, w = self._paged_cohort_batches(clients,
                                                           round_idx)
            else:
                x, y, mask, w = self.dataset.cohort_batches(
                    self._data_ids(clients), self.batch_size, self.seed,
                    round_idx, self.epochs)
            steps = next_pow2(x.shape[1])
            if steps != x.shape[1]:
                pad = [(0, 0), (0, steps - x.shape[1])]
                x = np.pad(x, pad + [(0, 0)] * (x.ndim - 2))
                y = np.pad(y, pad + [(0, 0)] * (y.ndim - 2))
                mask = np.pad(mask, pad)
            x, y, mask, w = self._to_device(x, y, mask, w)
            idx = None
            lead = x.shape[:3]
        drop = draw_dropout(self.model, gen, lead)
        c_stacked = self._gather_c(clients, round_idx)
        self._staged = (clients, idx, x, y, mask, w, drop, steps,
                        c_stacked)
        self._staged_round = round_idx
        return self._staged

    def silo_partial(self, round_idx: int, silo_idx: int):
        """Run ONE silo's slice of the round: reduce its cohort slice to
        an unfinished partial aggregate.  Returns ``(partial, silo_w,
        loss_w, steps, new_c)``: everything a silo rank ships (``silo_w``,
        ``loss_w`` and ``steps`` device scalars)."""
        (_clients, idx, x, y, mask, w, drop, _steps,
         c_stacked) = self._stage_round(round_idx)
        if self._program is None:
            self._program = federated.RoundProgram(
                self.server_opt.spec, self.trainer.make_local_train(),
                self.server_opt, self._client_mode)
        per = self.clients_per_round // self.num_silos
        sl = slice(silo_idx * per, (silo_idx + 1) * per)
        if idx is not None:
            rows = idx[sl].to(torch.long)
            xs, ys = self._dev_x[rows], self._dev_y[rows]
        else:
            xs, ys = x[sl], y[sl]
        ds = None if drop is None else tuple(d[sl] for d in drop)
        cs = None if c_stacked is None else {
            k: v[sl] for k, v in c_stacked.items()}
        ws = w[sl]
        outs = self._program.run_clients(self.state, xs, ys, mask[sl], ds,
                                         cs)
        partial = federated.build_aggregates(
            self.server_opt.spec, federated.PartialReducer(),
            self.server_opt, self.state, outs, ws)
        return (partial, torch.sum(ws), torch.sum(outs.loss * ws),
                torch.sum(outs.num_steps), outs.new_client_state)

    def apply_partials(self, partials):
        """Server tier: combine S partial aggregates and run the unchanged
        server transition."""
        agg = federated.combine_partial_aggregates(self.server_opt.spec,
                                                   list(partials))
        self.state = self.server_opt.update_from_aggregates(self.state, agg)
        return self.state

    def train_one_round(self, round_idx: int):
        """One two-tier round in one process: each silo maps its own slice
        of the cohort (:meth:`silo_partial`, as a silo rank runs it) and
        reduces it to a partial, through the wire when it is on."""
        partials, new_cs = [], []
        loss_w = w_total = steps_total = 0.0
        for i in range(self.num_silos):
            partial, sw, lw, ts, new_c = self.silo_partial(round_idx, i)
            if self._wire is not None:
                partial = federated.wire_roundtrip_partial(
                    partial, self._wire, link=f"partial:{i}")
            partials.append(partial)
            new_cs.append(new_c)
            loss_w = loss_w + lw
            w_total = w_total + sw
            steps_total = steps_total + ts
        clients, *_, steps, _c = self._stage_round(round_idx)
        self.apply_partials(partials)
        if new_cs[0] is not None:
            self._scatter_c(clients, {k: torch.cat([c[k] for c in new_cs])
                                      for k in new_cs[0]}, round_idx)
        self._staged_round = self._staged = None
        # the silos' f32 sums in silo order, as the combine tier adds them
        return {"train_loss": loss_w / w_total,
                "total_steps": steps_total,
                "silos": self.num_silos,
                "allocated_steps": len(clients) * steps}


# ---------------------------------------------------------------------------
# the multi-rank two-tier federation
# ---------------------------------------------------------------------------
#
# Dispatch-driven: rank 0 opens round r by fanning the current state out as
# STATE_SYNC(r); silos are purely reactive — whatever round is dispatched,
# they compute and upload.  A restarted rank 0 re-dispatches from its WAL
# round, and a restarted silo answers the next dispatch (the state rides
# every sync).  With ``reliable_delivery`` the payload types below get
# ack/retransmit and dedupe; ``quorum``/``quorum_deadline_s`` let rank 0
# close a round with a subset of silos (exact: the partial algebra carries
# its own denominators, and the arrived set is padded with zero partials).

#: protocol message types (disjoint from the cross-silo FSM's range)
MSG_TYPE_SILO_PARTIAL = 601
MSG_TYPE_STATE_SYNC = 602
MSG_TYPE_FINISH = 603


class _SiloEndpoint(ReliableEndpoint):
    """Queue-backed endpoint over the FedMLCommManager receive path
    (handlers run on the comm loop thread and enqueue; the driver's round
    loop consumes from the queue)."""

    def __init__(self, args, rank: int, size: int, backend: str):
        from ..core.distributed.fedml_comm_manager import FedMLCommManager

        inbox: "queue.Queue" = queue.Queue()

        class _Mgr(FedMLCommManager):
            def register_message_receive_handlers(self):
                for t in (MSG_TYPE_SILO_PARTIAL, MSG_TYPE_STATE_SYNC,
                          MSG_TYPE_FINISH):
                    self.register_message_receive_handler(
                        t, lambda m: inbox.put(m))

        super().__init__(_Mgr(args, rank=rank, size=size, backend=backend),
                         inbox, rank)


def run_silo_federation(args, device, dataset, model, api=None):
    """Drive ONE rank of the multi-rank two-tier topology.

    ``args.rank`` 0 is the combine tier (server); ranks ``1..num_silos``
    each own one silo slice of every round's cohort.  Every rank shares
    ``random_seed``, so cohort sampling, dropout masks and batch schedules
    are the in-process :class:`HierarchicalSiloAPI`'s; at
    ``wire_precision`` off or fp32 the rounds are bitwise its rounds (a
    quorum close drops the missing silos' slices).  Each rank needs its
    own ``model`` instance.

    ``reliable_delivery`` adds ack/retransmit and heartbeat leases;
    ``quorum``/``quorum_deadline_s`` close rounds without stragglers or
    dead silos; ``checkpoint_dir`` arms per-round checkpoints and the
    applied-round WAL, so a restarted rank 0 resumes without applying a
    round twice.  ``silo_slow_rank``/``silo_slow_s`` hold one silo's round
    open by a fixed sleep inside its ``silo.round`` span.  ``api``: this
    rank's :class:`HierarchicalSiloAPI` when the caller built it (to start
    from given weights, or to read the state after the run).

    Returns the server's per-round metrics list on rank 0, None on silos.
    """
    rank = int(getattr(args, "rank", 0))
    num_silos = int(getattr(args, "num_silos", 0) or 2)
    rounds = int(getattr(args, "comm_round", 1))
    backend = str(getattr(args, "backend", "filestore"))
    if bool(getattr(args, "reliable_delivery", False)):
        if not getattr(args, "reliable_types", None):
            args.reliable_types = [MSG_TYPE_SILO_PARTIAL,
                                   MSG_TYPE_STATE_SYNC, MSG_TYPE_FINISH]
        if not getattr(args, "heartbeat_interval_s", 0.0):
            args.heartbeat_interval_s = 0.5
        if not getattr(args, "lease_s", 0.0):
            args.lease_s = 5.0
    tracer = get_tracer()
    if bool(getattr(args, "trace", False)) or tracer.enabled:
        from ..obs import configure
        configure(label="server" if rank == 0 else f"silo{rank}")
        tracer = get_tracer()

    if api is None:
        api = HierarchicalSiloAPI(args, device, dataset, model)
    if api.client_table is not None or api._store is not None:
        raise ValueError(
            "distributed silo federation supports stateless-client "
            "algorithms for now (SCAFFOLD/FedDyn rows would go stale "
            "across silo processes; run those in-process)")

    ep = _SiloEndpoint(args, rank, num_silos + 1, backend)
    try:
        if rank == 0:
            return _run_combine_tier(api, ep, num_silos, rounds, args,
                                     tracer)
        _run_silo_tier(api, ep, rank, args, tracer)
        return None
    finally:
        # rank 0 grants in-flight reliable FINISHes a short ack window
        ep.close(flush_s=2.0 if rank == 0 else 0.0)
        tracer.close()


def _collect_quorum(ep, guard, round_idx, expected, quorum, deadline_s,
                    recv_timeout_s, tracer):
    """Collect SILO_PARTIAL uploads for ``round_idx`` until every live
    expected silo arrived, or, once ``deadline_s`` has elapsed, until at
    least ``quorum`` have.  Lease-dead ranks leave the expected set
    mid-wait.  Returns ``(got, live)``; raises ``RuntimeError`` when the
    quorum can never be met and ``TimeoutError`` when nothing arrives for
    ``recv_timeout_s``."""
    got = {}
    live = set(expected)
    t_open = time.monotonic()
    last_arrival = time.monotonic()
    while True:
        if guard is not None:
            live = set(expected) - guard.dead_ranks()
        if len(live | set(got)) < quorum:
            raise RuntimeError(
                f"round {round_idx}: quorum {quorum} unreachable — "
                f"arrived={sorted(got)}, live={sorted(live)}, "
                f"dead={sorted(set(expected) - live)}")
        waiting = live - set(got)
        if not waiting:
            break
        if deadline_s > 0 and len(got) >= quorum \
                and time.monotonic() - t_open >= deadline_s:
            log.warning(
                "round %d: quorum close at deadline with %d/%d silos "
                "(missing %s)", round_idx, len(got), len(expected),
                sorted(waiting))
            break
        msg = ep.poll(timeout_s=0.05)
        if msg is None:
            if time.monotonic() - last_arrival > recv_timeout_s:
                raise TimeoutError(
                    f"rank 0: no MSG_TYPE_SILO_PARTIAL for round "
                    f"{round_idx} from ranks {sorted(waiting)} within "
                    f"{time.monotonic() - last_arrival:.1f}s "
                    f"(comm_recv_timeout_s={recv_timeout_s:g})")
            continue
        last_arrival = time.monotonic()
        if msg.get_type() != MSG_TYPE_SILO_PARTIAL:
            continue
        if int(msg.get("round_idx")) != round_idx:
            # round binding: late partials for a closed round drop here
            log.warning("server: dropping stale round-%s partial",
                        msg.get("round_idx"))
            tracer.counter("comm.stale_partials", 1.0)
            continue
        got.setdefault(int(msg.get("silo")), msg)
    return got, live


def _run_combine_tier(api, ep, num_silos, rounds, args, tracer):
    from ..core.distributed.communication.message import (Message,
                                                          encode_tree)
    from ..obs import context as obs_context

    # the state-sync fan-out on ONE link: every silo receives the same
    # bytes, and the int8 EF residual advances once per round
    codec = wire.codec_from_args(args, api.layout)
    wire_link = wire.WireLink(codec) if codec is not None else None

    guard = ep.guard
    expected = list(range(1, num_silos + 1))
    if guard is not None:
        guard.start_heartbeats(expected_ranks=expected)
    quorum = int(getattr(args, "quorum", 0) or 0) or num_silos
    deadline_s = float(getattr(args, "quorum_deadline_s", 0.0) or 0.0)
    recv_timeout_s = float(getattr(args, "comm_recv_timeout_s", 120.0)
                           or 120.0)

    # crash-resume: per-round checkpoint and applied-round WAL; a restart
    # restores round c, backfills a torn journal entry and dispatches c + 1
    wal = None
    start_round = 0
    if getattr(args, "checkpoint_dir", None):
        args.checkpoint_freq = 1
        start_round = api.maybe_resume()
        wal = RoundWAL(str(args.checkpoint_dir))
        wal.ensure(start_round - 1 if start_round else None)
        if start_round:
            log.info("server: resumed from checkpoint+WAL at round %d",
                     start_round)

    history = []
    for r in range(start_round, rounds):
        t0 = time.time()
        # kill-rank-0 chaos fires between rounds: the previous round is
        # applied and journaled, the crash window the WAL covers
        maybe_crash_at_round(args, 0, r)
        with tracer.span("round", cat="round", round=r):
            live = set(expected) - (guard.dead_ranks() if guard
                                    else set())
            state_dict = wire.state_tree(api.state)
            state_digest = None
            if wire_link is not None:
                with tracer.span("wire.encode", cat="comm", round=r,
                                 link="state_sync"):
                    state_dict = wire_link.encode(state_dict,
                                                  link="state_sync")
                if wal is not None:
                    # the digest of the ENCODED payload: the bytes the
                    # wire ships and the wire checkpoint would write
                    state_digest = (
                        f"{zlib.crc32(encode_tree(state_dict)):08x}")
            for s in expected:
                sync = Message(MSG_TYPE_STATE_SYNC, 0, s)
                sync.add_params("round_idx", r)
                sync.add_params("state", state_dict)
                if s not in live:
                    # a lease-dead rank is still probed with the dispatch
                    # (the sync is its rejoin path), fire-and-forget
                    sync.add_params(KEY_UNRELIABLE, True)
                ep.send(sync)
            got, live = _collect_quorum(ep, guard, r, expected, quorum,
                                        deadline_s, recv_timeout_s,
                                        tracer)
            with tracer.span("combine", cat="round", round=r,
                             quorum=len(got)):
                partials = [wire.tensor_tree(
                    wire.maybe_decode(got[s].get("partial"), api.layout),
                    api.device, api.order) for s in sorted(got)]
                # pad the arrived set to S with zero partials: the
                # algebra stays exact (zero num, zero den)
                if len(partials) < num_silos:
                    pad = federated.zero_like_partial(partials[0])
                    partials += [pad] * (num_silos - len(partials))
                api.apply_partials(partials)
                _sync(api.device)
            if wal is not None:
                api.maybe_checkpoint(r)
                wal.record(
                    r, msg_ids=[str(m.get(obs_context.KEY_MSG_ID))
                                for m in got.values()
                                if m.get(obs_context.KEY_MSG_ID)],
                    quorum=len(got), state_digest=state_digest)
        dead = sorted(set(expected) - live)
        tracer.counter("comm.quorum_size", float(len(got)), round=r)
        tracer.counter("comm.quorum_missing_ranks",
                       float(num_silos - len(got)), round=r)
        tracer.counter("comm.quorum_deficit",
                       float(max(quorum - len(got), 0)), round=r)
        tracer.counter("comm.dead_ranks", float(len(dead)), round=r)
        # f32 sums in silo order: the in-process round's arithmetic
        loss_w = w_total = np.float32(0.0)
        for s in sorted(got):
            loss_w = loss_w + np.float32(got[s].get("loss_w"))
            w_total = w_total + np.float32(got[s].get("silo_w"))
        history.append({"round": r,
                        "train_loss": float(loss_w / max(w_total,
                                                         np.float32(1e-9))),
                        "round_time": time.time() - t0,
                        "silos": num_silos, "quorum": len(got),
                        "dead_ranks": dead})
        log.info("server round %d: train_loss=%.4f (%.2fs, %d/%d silos)",
                 r, history[-1]["train_loss"], history[-1]["round_time"],
                 len(got), num_silos)
    for s in expected:
        ep.send(Message(MSG_TYPE_FINISH, 0, s))
    return history


def _run_silo_tier(api, ep, rank, args, tracer):
    """Reactive silo loop: whatever round rank 0 dispatches (a STATE_SYNC
    carrying the current state), compute that round's slice and upload
    the partial.

    ``wire_overlap``: the partial's copy to the host starts on the stream
    that produced it (pinned memory, an event recorded after it), and the
    encode and send run on a single writer thread that waits on the event
    first, so this loop is back on ``recv`` while round r's bytes are
    still leaving.  One upload is in flight at a time: the next submit
    first surfaces the previous one's failure."""
    from concurrent.futures import ThreadPoolExecutor

    from ..core.distributed.communication.message import Message

    guard = ep.guard
    if guard is not None:
        guard.start_heartbeats()
    recv_timeout_s = float(getattr(args, "comm_recv_timeout_s", 120.0)
                           or 120.0)
    slow_rank = int(getattr(args, "silo_slow_rank", 0) or 0)
    slow_s = float(getattr(args, "silo_slow_s", 0.0) or 0.0)
    codec = wire.codec_from_args(args, api.layout)
    wire_link = wire.WireLink(codec) if codec is not None else None
    writer = (ThreadPoolExecutor(max_workers=1)
              if bool(getattr(args, "wire_overlap", False)) else None)
    pending = None

    def upload(r, partial, silo_w, loss_w, event=None):
        if event is not None:
            event.synchronize()
        sd = partial
        if wire_link is not None:
            with tracer.span("wire.encode", cat="comm", round=r,
                             link="partial"):
                sd = wire_link.encode(sd, link="partial")
        up = Message(MSG_TYPE_SILO_PARTIAL, rank, 0)
        up.add_params("round_idx", r)
        up.add_params("silo", rank)
        up.add_params("partial", sd)
        up.add_params("silo_w", float(silo_w))
        up.add_params("loss_w", np.asarray(float(loss_w), np.float32))
        ep.send(up)

    try:
        while True:
            msg = ep.recv(timeout_s=recv_timeout_s,
                          expect="MSG_TYPE_STATE_SYNC/MSG_TYPE_FINISH "
                                 "from rank 0")
            if msg.get_type() == MSG_TYPE_FINISH:
                return
            if msg.get_type() != MSG_TYPE_STATE_SYNC:
                continue
            # a re-dispatched round (a restarted rank 0) is recomputed and
            # re-uploaded; the server keys arrived partials by silo
            r = int(msg.get("round_idx"))
            api.state = wire.state_from_tree(
                wire.maybe_decode(msg.get("state"), api.layout), api.state)
            # crash-at-round chaos: dies on receipt of round r's dispatch,
            # before computing; the round must close at quorum without it
            maybe_crash_at_round(args, rank, r)
            with tracer.span("silo.round", cat="round", round=r,
                             silo=rank):
                partial, silo_w, loss_w, _steps, _new_c = api.silo_partial(
                    r, rank - 1)
                if slow_rank == rank and slow_s > 0:
                    _sync(api.device)
                    time.sleep(slow_s)   # injected straggler
            if writer is not None:
                host, event = host_copy_tree(
                    {"partial": partial, "silo_w": silo_w, "loss_w": loss_w})
                if pending is not None:
                    pending.result()   # surface round r-1 upload failures
                pending = writer.submit(upload, r, host["partial"],
                                        host["silo_w"], host["loss_w"],
                                        event)
            else:
                _sync(api.device)
                upload(r, partial, silo_w, loss_w)
    finally:
        if writer is not None:
            if pending is not None:
                pending.result()
            writer.shutdown(wait=True)


__all__ = ["HierarchicalSiloAPI", "run_silo_federation",
           "MSG_TYPE_SILO_PARTIAL", "MSG_TYPE_STATE_SYNC", "MSG_TYPE_FINISH"]
