"""Cross-silo server FSM (reference
``cross_silo/server/fedml_server_manager.py``: client-onboarding handshake →
``send_init_msg:48`` → per-round collect/aggregate/sync →
``handle_message_receive_model_from_client:174``).

Port of the JAX module.  What differs: no round-level ``mlops`` events
(``log_round_info``, ``log_aggregation_status``: a recorded divergence of
the port); no upload decompression (``enable_compression`` is refused by
name when the server is built); and the round checkpoint is the port's
``core/checkpoint.RoundCheckpointer`` (``step_<n>.pt`` files of the
server state as a flat dict), not orbax.
"""

from __future__ import annotations

import logging
import threading

from ...core.distributed.communication.message import Message
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ..message_define import MyMessage

log = logging.getLogger(__name__)


class FedMLServerManager(FedMLCommManager):
    """Straggler tolerance (absent from the reference — SURVEY §5: a dead
    client stalls ``check_whether_all_receive`` forever): when
    ``aggregation_timeout_s`` > 0, a timer starts at each round's first
    upload; on expiry the round aggregates the partial cohort if at least
    ``min_clients_to_aggregate`` (default 1) results arrived. Uploads carry
    their round index, so a straggler's late result for an already-closed
    round is dropped instead of polluting the next one."""

    def __init__(self, args, aggregator, comm=None, rank=0, size=0,
                 backend="local"):
        super().__init__(args, comm, rank, size, backend)
        self.aggregator = aggregator
        self.round_num = int(getattr(args, "comm_round", 10))
        self.args.round_idx = 0
        self.client_num = size - 1
        self.client_online_set = set()
        self.client_real_ids = list(range(1, size))
        self.client_finished_count = 0
        self.agg_timeout = float(getattr(args, "aggregation_timeout_s", 0))
        self.min_to_aggregate = max(1, int(getattr(
            args, "min_clients_to_aggregate", 1)))
        self._round_lock = threading.Lock()
        self._timer = None
        self._onboard_timer = None
        self._started = False
        self._ckpt = None
        ckpt_dir = getattr(args, "checkpoint_dir", None)
        if ckpt_dir:
            # round checkpoint/resume — core capability the reference lacks
            # (SURVEY §5: FL rounds had no checkpoint; only S3 artifacts)
            from ...core.checkpoint import (RoundCheckpointer,
                                            state_from_flat, state_to_flat)
            self._ckpt = RoundCheckpointer(
                str(ckpt_dir), int(getattr(args, "checkpoint_keep", 3)))
            latest = self._ckpt.latest_round()
            if latest is not None:
                flat, _ = self._ckpt.restore(
                    template=(state_to_flat(self.aggregator.state), None))
                self.aggregator.state = state_from_flat(
                    flat, self.aggregator.state)
                self.args.round_idx = int(latest) + 1
                log.info("server: resumed from round checkpoint %d", latest)

    # -- handshake ---------------------------------------------------------
    def register_message_receive_handlers(self):
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_CLIENT_STATUS,
            self.handle_message_client_status_update)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
            self.handle_message_receive_model_from_client)

    def handle_message_client_status_update(self, msg_params):
        status = msg_params.get(MyMessage.MSG_ARG_KEY_CLIENT_STATUS)
        sender = msg_params.get_sender_id()
        with self._round_lock:
            if status == MyMessage.MSG_CLIENT_STATUS_ONLINE:
                self.client_online_set.add(sender)
                log.info("server: client %d online (%d/%d)", sender,
                         len(self.client_online_set), self.client_num)
                if (self.agg_timeout > 0
                        and len(self.client_online_set) < self.client_num):
                    # straggler tolerance covers onboarding too: never-online
                    # clients must not stall the federation forever. Re-armed
                    # on every arrival, so it measures SILENCE — a slowly but
                    # actively joining cohort is never cut off.
                    self._cancel_onboard_timer()
                    self._onboard_timer = threading.Timer(
                        self.agg_timeout, self._on_onboarding_timeout)
                    self._onboard_timer.daemon = True
                    self._onboard_timer.start()
            if len(self.client_online_set) == self.client_num:
                self._cancel_onboard_timer()
                self.send_init_msg()

    def _cancel_onboard_timer(self):
        if self._onboard_timer is not None:
            self._onboard_timer.cancel()
            self._onboard_timer = None

    def _on_onboarding_timeout(self):
        with self._round_lock:
            self._onboard_timer = None
            online = len(self.client_online_set)
            if self._started:
                return
            if online < self.min_to_aggregate:
                # not enough to start — re-arm so the configured timeout
                # keeps producing progress or visible warnings instead of
                # a silent permanent stall
                log.warning("server: onboarding timeout with only %d/%d "
                            "clients online (need %d); waiting another "
                            "window", online, self.client_num,
                            self.min_to_aggregate)
                self._onboard_timer = threading.Timer(
                    self.agg_timeout, self._on_onboarding_timeout)
                self._onboard_timer.daemon = True
                self._onboard_timer.start()
                return
            log.warning("server: onboarding timeout — starting with %d/%d "
                        "clients online", online, self.client_num)
            self.send_init_msg()

    # -- round machinery ---------------------------------------------------
    def _sampled_client_idxs(self, round_idx):
        return self.aggregator.client_sampling(
            round_idx,
            int(getattr(self.args, "client_num_in_total", self.client_num)),
            min(int(getattr(self.args, "client_num_per_round", self.client_num)),
                self.client_num),
        )

    def send_init_msg(self):
        """Reference send_init_msg:48 — S2C global model + assigned data idx."""
        if self._started:
            return
        self._started = True
        start_round = int(self.args.round_idx)  # >0 after checkpoint resume
        if start_round >= self.round_num:
            self.send_finish()  # resumed past the last round: nothing to do
            return
        client_idxs = self._sampled_client_idxs(start_round)
        global_params = self.aggregator.get_global_model_params()
        for rank, data_idx in zip(self.client_real_ids, client_idxs):
            msg = Message(MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self.rank, rank)
            msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, global_params)
            msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, int(data_idx))
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, start_round)
            self.send_message(msg)
        self._arm_round_timer()

    def _arm_round_timer(self):
        """Caller holds _round_lock (or is in pre-concurrency startup). Armed
        when a round OPENS, so a round with zero uploads still times out."""
        if self.agg_timeout <= 0:
            return
        if self._timer is not None:
            self._timer.cancel()
        self._timer = threading.Timer(self.agg_timeout,
                                      self._on_aggregation_timeout,
                                      args=(self.args.round_idx,))
        self._timer.daemon = True
        self._timer.start()

    def _upload_is_stale(self, msg_params, sender) -> bool:
        msg_round = msg_params.get(MyMessage.MSG_ARG_KEY_ROUND_IDX)
        if msg_round is not None and int(msg_round) != self.args.round_idx:
            log.warning("server: dropping stale round-%s upload from "
                        "client %d (now at round %d)", msg_round, sender,
                        self.args.round_idx)
            return True
        return False

    def handle_message_receive_model_from_client(self, msg_params):
        sender = msg_params.get_sender_id()
        # require(): a malformed upload fails HERE naming msg_type+sender
        # instead of propagating None into decompress/aggregate
        params = msg_params.require(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        n = msg_params.require(MyMessage.MSG_ARG_KEY_NUM_SAMPLES)
        with self._round_lock:
            if self._upload_is_stale(msg_params, sender):
                return
            self.aggregator.add_local_trained_result(
                self.client_real_ids.index(sender), params, n)
            if not self.aggregator.check_whether_all_receive():
                return
            broadcast = self._finish_round()
        broadcast()  # blocking wire I/O runs after _round_lock is released

    def _on_aggregation_timeout(self, armed_round: int):
        with self._round_lock:
            if armed_round != self.args.round_idx:
                return  # stale callback: that round already closed
            self._timer = None
            received = self.aggregator.received_count
            if received < self.min_to_aggregate:
                log.warning("server: aggregation timeout with only %d/%d "
                            "results; waiting another window", received,
                            self.min_to_aggregate)
                self._arm_round_timer()
                return
            log.warning("server: aggregation timeout — closing round %d "
                        "with %d/%d clients", self.args.round_idx, received,
                        self.client_num)
            self.aggregator.reset_receive_flags()
            broadcast = self._finish_round()
        broadcast()

    def _finish_round(self):
        """Caller holds _round_lock (handler thread or timeout thread).

        Aggregates and advances the round state under the lock, then
        returns a zero-arg callable the caller MUST run after releasing
        it — the callable performs the outbound sends.  Sync-model
        broadcasts are blocking wire I/O; doing them under _round_lock
        would stall every concurrent upload handler and the timeout
        thread for the whole broadcast (and on a reliable backend, for
        its retransmit windows too).  The round timer is armed before the
        lock drops, so an upload racing the broadcast still lands in an
        open, timed round.
        """
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        round_idx = self.args.round_idx
        self.aggregator.aggregate()
        self.aggregator.test_on_server_for_all_clients(round_idx)
        if self._ckpt is not None:
            from ...core.checkpoint import state_to_flat
            freq = int(getattr(self.args, "checkpoint_freq", 10))
            if round_idx % freq == 0 or round_idx == self.round_num - 1:
                self._ckpt.save(round_idx,
                                state_to_flat(self.aggregator.state), None)
        self.args.round_idx = round_idx + 1
        if self.args.round_idx >= self.round_num:
            def _finish():
                self.send_finish()
            return _finish
        client_idxs = self._sampled_client_idxs(self.args.round_idx)
        global_params = self.aggregator.get_global_model_params()
        msgs = []
        for rank, data_idx in zip(self.client_real_ids, client_idxs):
            msg = Message(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                          self.rank, rank)
            msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, global_params)
            msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, int(data_idx))
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self.args.round_idx)
            msgs.append(msg)
        self._arm_round_timer()

        def _broadcast():
            for msg in msgs:
                self.send_message(msg)
        return _broadcast

    def send_finish(self):
        for rank in self.client_real_ids:
            self.send_message(
                Message(MyMessage.MSG_TYPE_S2C_FINISH, self.rank, rank))
        if self._ckpt is not None:
            self._ckpt.close()
            self._ckpt = None
        self.finish()
