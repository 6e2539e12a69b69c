"""SecAgg server FSM (port of
``fedml_tpu.cross_silo.secagg.sa_fedml_server_manager``).

Router + unmasking aggregator: broadcasts the public-key directory, routes
Shamir shares, sums masked uploads (pairwise masks cancel), reconstructs
each survivor's self-mask seed from >= t revealed shares, and strips them
(``core/mpc/secagg.secure_sum``), all in host numpy as in the JAX package.
The dequantized sum is cast to float32 before the division by the total
sample count, in the JAX order.

What differs from the JAX module: the global params are the port's tensors
on ``device`` (the card unless the CPU is asked for: ``device="cpu"`` or
``args.device="cpu"``), from whatever the caller gave (numpy arrays or
tensors); flattening is :func:`~.sa_fedml_client_manager.flatten_params`.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np

from ...core.distributed.communication.message import Message
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...core.mpc.secagg import dequantize, secure_sum, shamir_reconstruct
from ...device import get_device
from .sa_fedml_client_manager import flatten_params, unflatten_params
from .sa_message_define import MyMessage

log = logging.getLogger(__name__)


def device_params(params, device):
    """``params`` (numpy arrays or tensors) as tensors on ``device``."""
    return unflatten_params(flatten_params(params), params, device)


class SAServerManager(FedMLCommManager):
    def __init__(self, args, global_params, comm=None, rank=0, size=0,
                 backend="local", on_round_done=None, device=None):
        super().__init__(args, comm, rank, size, backend)
        self.device = get_device(args, device)
        self.global_params = device_params(global_params, self.device)
        self.client_num = size - 1
        self.t = int(getattr(args, "secagg_threshold",
                             self.client_num // 2 + 1))
        self.round_idx = 0
        self.num_rounds = int(getattr(args, "comm_round", 1))
        self.on_round_done = on_round_done
        self._online = set()
        self._started = False
        self._pks: Dict[int, str] = {}
        self._masked: Dict[int, np.ndarray] = {}
        self._weights: Dict[int, float] = {}
        self._reveals: Dict[int, Dict[str, np.ndarray]] = {}
        self._active_sent = False

    def register_message_receive_handlers(self):
        M = MyMessage
        self.register_message_receive_handler(M.MSG_TYPE_C2S_CLIENT_STATUS,
                                              self._handle_status)
        self.register_message_receive_handler(M.MSG_TYPE_C2S_SEND_PK_TO_SERVER,
                                              self._handle_pk)
        self.register_message_receive_handler(M.MSG_TYPE_C2S_SEND_SS_TO_SERVER,
                                              self._handle_ss_route)
        self.register_message_receive_handler(M.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
                                              self._handle_model)
        self.register_message_receive_handler(
            M.MSG_TYPE_C2S_SEND_SS_OTHERS_TO_SERVER, self._handle_reveal)

    def _handle_status(self, msg: Message):
        self._online.add(msg.get_sender_id())
        if not self._started and len(self._online) == self.client_num:
            self._started = True
            self._broadcast_model(MyMessage.MSG_TYPE_S2C_INIT_CONFIG)

    def _broadcast_model(self, msg_type):
        for rank in range(1, self.client_num + 1):
            m = Message(msg_type, 0, rank)
            m.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, self.global_params)
            m.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self.round_idx)
            self.send_message(m)

    # -- key directory -----------------------------------------------------
    def _handle_pk(self, msg: Message):
        self._pks[msg.get_sender_id()] = str(msg.get(MyMessage.MSG_ARG_KEY_PK))
        if len(self._pks) == self.client_num:
            directory = {str(k): v for k, v in self._pks.items()}
            for rank in range(1, self.client_num + 1):
                m = Message(MyMessage.MSG_TYPE_S2C_OTHER_PK_TO_CLIENT, 0, rank)
                m.add_params(MyMessage.MSG_ARG_KEY_PK_OTHERS, directory)
                self.send_message(m)

    # -- share routing -----------------------------------------------------
    def _handle_ss_route(self, msg: Message):
        dest = int(msg.get(MyMessage.MSG_ARG_KEY_CLIENT_ID))
        m = Message(MyMessage.MSG_TYPE_S2C_OTHER_SS_TO_CLIENT, 0, dest)
        m.add_params(MyMessage.MSG_ARG_KEY_CLIENT_ID, msg.get_sender_id())
        m.add_params(MyMessage.MSG_ARG_KEY_SS, msg.get(MyMessage.MSG_ARG_KEY_SS))
        self.send_message(m)

    # -- masked uploads ----------------------------------------------------
    def _handle_model(self, msg: Message):
        # the same stale-round guard as the reveal path: pairwise masks
        # only cancel within ONE round's cohort — a delayed round-r upload
        # summed into round r+1 can never be unmasked
        if int(msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX) or 0) != self.round_idx:
            return
        self._masked[msg.get_sender_id()] = np.asarray(
            msg.get(MyMessage.MSG_ARG_KEY_MASKED_PARAMS), dtype=np.int64)
        self._weights[msg.get_sender_id()] = float(
            msg.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES))
        if len(self._masked) == self.client_num and not self._active_sent:
            self._active_sent = True
            active = sorted(self._masked.keys())
            for rank in range(1, self.client_num + 1):
                m = Message(MyMessage.MSG_TYPE_S2C_ACTIVE_CLIENT_LIST, 0, rank)
                m.add_params(MyMessage.MSG_ARG_KEY_ACTIVE_CLIENTS, active)
                self.send_message(m)

    # -- unmasking ---------------------------------------------------------
    def _handle_reveal(self, msg: Message):
        # drop stale reveals from an already-finished round — a late round-r
        # reveal must not count toward round r+1's threshold
        if int(msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX) or 0) != self.round_idx:
            return
        self._reveals[msg.get_sender_id()] = {
            k: np.asarray(v, dtype=np.int64) for k, v in
            msg.get(MyMessage.MSG_ARG_KEY_SS_OTHERS).items()}
        if len(self._reveals) >= self.t:
            self._finish_round()

    def _finish_round(self):
        active = sorted(self._masked.keys())
        b_seeds = []
        for i in active:
            # holder rank j revealed the share evaluated at point j
            shares = {j: self._reveals[j][str(i)]
                      for j in self._reveals if str(i) in self._reveals[j]}
            b_i = int(shamir_reconstruct(shares)[0])
            b_seeds.append(b_i)
        total = secure_sum([self._masked[i] for i in active], b_seeds)
        total_w = sum(self._weights[i] for i in active)
        avg = dequantize(total) / max(total_w, 1e-12)
        self.global_params = unflatten_params(
            np.asarray(avg, dtype=np.float32), self.global_params,
            self.device)
        if self.on_round_done is not None:
            self.on_round_done(self.round_idx, self.global_params)
        log.info("secagg round %d aggregated (%d clients, t=%d)",
                 self.round_idx, len(active), self.t)
        self._pks.clear()
        self._masked.clear()
        self._weights.clear()
        self._reveals.clear()
        self._active_sent = False
        self.round_idx += 1
        if self.round_idx >= self.num_rounds:
            for rank in range(1, self.client_num + 1):
                self.send_message(Message(MyMessage.MSG_TYPE_S2C_FINISH, 0, rank))
            self.finish()
        else:
            self._broadcast_model(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT)
