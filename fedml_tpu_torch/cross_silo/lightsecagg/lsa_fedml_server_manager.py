"""LightSecAgg server FSM (port of
``fedml_tpu.cross_silo.lightsecagg.lsa_fedml_server_manager``).

The server is an untrusted router + field-arithmetic aggregator: it routes
encoded mask shares between clients, sums masked uploads, and after
collecting U aggregate shares decodes ONLY the sum of masks
(``decode_aggregate_mask``) — individual updates stay hidden.  Host numpy
as in the JAX package (the decode applies the inverted U×U matrix in
int64: ``core/mpc/lightsecagg.py``); the dequantized sum is cast to
float32 before the division by the total sample count.

What differs from the JAX module: as ``cross_silo/secagg``'s server, the
global params are the port's tensors on ``device`` (the card unless the
CPU is asked for).
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np

from ...core.distributed.communication.message import Message
from ...core.distributed.fedml_comm_manager import FedMLCommManager
from ...core.mpc.lightsecagg import decode_aggregate_mask
from ...core.mpc.secagg import P, dequantize
from ...device import get_device
from ..secagg.sa_fedml_client_manager import unflatten_params
from ..secagg.sa_fedml_server_manager import device_params
from .lsa_fedml_client_manager import lsa_dims
from .lsa_message_define import MyMessage

log = logging.getLogger(__name__)


class LSAServerManager(FedMLCommManager):
    def __init__(self, args, global_params, comm=None, rank=0, size=0,
                 backend="local", on_round_done=None, device=None):
        super().__init__(args, comm, rank, size, backend)
        self.device = get_device(args, device)
        self.global_params = device_params(global_params, self.device)
        self.client_num = size - 1
        self.N, self.U, self.T = lsa_dims(self.client_num, args)
        self.round_idx = 0
        self.num_rounds = int(getattr(args, "comm_round", 1))
        self.on_round_done = on_round_done
        self._online = set()
        self._started = False
        self._masked: Dict[int, np.ndarray] = {}
        self._weights: Dict[int, float] = {}
        self._agg_shares: Dict[int, np.ndarray] = {}
        self._active_announced = False

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_CLIENT_STATUS, self._handle_client_status)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_ENCODED_MASK_TO_SERVER,
            self._handle_encoded_mask)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self._handle_model)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MASK_TO_SERVER, self._handle_agg_share)

    # -- onboarding --------------------------------------------------------
    def _handle_client_status(self, msg: Message):
        self._online.add(msg.get_sender_id())
        if not self._started and len(self._online) == self.client_num:
            self._started = True
            self._broadcast(MyMessage.MSG_TYPE_S2C_INIT_CONFIG)

    def _broadcast(self, msg_type):
        for rank in range(1, self.client_num + 1):
            m = Message(msg_type, 0, rank)
            m.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, self.global_params)
            m.add_params(MyMessage.MSG_ARG_KEY_ROUND_IDX, self.round_idx)
            self.send_message(m)

    # -- share routing -----------------------------------------------------
    def _handle_encoded_mask(self, msg: Message):
        dest = int(msg.get(MyMessage.MSG_ARG_KEY_CLIENT_ID))
        m = Message(MyMessage.MSG_TYPE_S2C_ENCODED_MASK_TO_CLIENT, 0, dest)
        m.add_params(MyMessage.MSG_ARG_KEY_CLIENT_ID, msg.get_sender_id())
        m.add_params(MyMessage.MSG_ARG_KEY_ENCODED_MASK,
                     msg.get(MyMessage.MSG_ARG_KEY_ENCODED_MASK))
        self.send_message(m)

    # -- aggregation -------------------------------------------------------
    def _handle_model(self, msg: Message):
        # the same stale-round guard as the aggregate-share path: a delayed
        # round-r masked upload carries round r's z_i mask and can never
        # be unmasked by round r+1's decoded mask sum
        if int(msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX) or 0) != self.round_idx:
            return
        sender = msg.get_sender_id()
        self._masked[sender] = np.asarray(
            msg.get(MyMessage.MSG_ARG_KEY_MASKED_PARAMS), dtype=np.int64)
        self._weights[sender] = float(msg.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES))
        if len(self._masked) == self.client_num and not self._active_announced:
            self._active_announced = True
            active = sorted(self._masked.keys())
            for rank in range(1, self.client_num + 1):
                m = Message(MyMessage.MSG_TYPE_S2C_SEND_TO_ACTIVE_CLIENT, 0, rank)
                m.add_params(MyMessage.MSG_ARG_KEY_ACTIVE_CLIENTS, active)
                self.send_message(m)

    def _handle_agg_share(self, msg: Message):
        # a late round-r share must not count toward round r+1's U threshold
        if int(msg.get(MyMessage.MSG_ARG_KEY_ROUND_IDX) or 0) != self.round_idx:
            return
        self._agg_shares[msg.get_sender_id()] = np.asarray(
            msg.get(MyMessage.MSG_ARG_KEY_AGGREGATE_ENCODED_MASK),
            dtype=np.int64)
        if len(self._agg_shares) >= self.U:
            self._finish_round()

    def _finish_round(self):
        d = sum(v.numel() for v in self.global_params.values())
        k = self.U - self.T
        total_masked = np.zeros(d, dtype=np.int64)
        for y in self._masked.values():
            total_masked = (total_masked + y) % P
        G = decode_aggregate_mask(dict(self._agg_shares), d, self.U)
        sum_mask = G[:k].reshape(-1)[:d]
        total = (total_masked - sum_mask) % P
        total_w = sum(self._weights.values())
        avg = dequantize(total) / max(total_w, 1e-12)
        self.global_params = unflatten_params(
            np.asarray(avg, dtype=np.float32), self.global_params,
            self.device)
        if self.on_round_done is not None:
            self.on_round_done(self.round_idx, self.global_params)
        log.info("lightsecagg round %d aggregated (%d clients, U=%d T=%d)",
                 self.round_idx, len(self._masked), self.U, self.T)
        self._masked.clear()
        self._weights.clear()
        self._agg_shares.clear()
        self._active_announced = False
        self.round_idx += 1
        if self.round_idx >= self.num_rounds:
            for rank in range(1, self.client_num + 1):
                self.send_message(Message(MyMessage.MSG_TYPE_S2C_FINISH, 0, rank))
            self.finish()
        else:
            self._broadcast(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT)
